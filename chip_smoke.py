#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main paths through the entry points a user calls, each
on the kernel pair "auto" takes under the card's device profile
(utils/device.py: the H100's measured entry, else the JAX package's v5e
rules), which every launch check reads:

1. inference: the DCNv2 2D forward at the bench's config 2 (B=8, 256->256
   channels, 56x56, 3x3, stride 1, pad 1, groups = deformable_groups = 4,
   bias, offsets from U[-2, 2]), `modulated_deform_conv2d` with and
   without `offset_bound=2.0`, and `ModulatedDeformConv2dPack`;
2. the training step of bench.py at config 2: gradients of sum(out^2) with
   respect to all five inputs, with and without the bound; and the forward
   and training step of BASELINE config 1 (`deform_conv2d`, B=2, 32->32,
   64x64, no mask, no bias) with and without the bound, and of a small
   volume (`deform_conv3d`, B=2, 64 ch, 4x16x16) without (PLAIN_CASES: the
   shapes under the H100 profile's columns thresholds, where "auto" takes
   the fused gather pairs);
3. DCNResNet-50 at width 64, 1000 classes, B=8, 224x224, trained for a
   few AdamW steps by the in-package trainer;
4. the 3D ops at BASELINE configs 3 (`deform_conv3d`, B=2, 64 ch,
   16x32x32) and 4 (`modulated_deform_conv3d`, B=4, 128 ch, 32x64x64,
   in_step=2), both with `offset_bound=2.0`: the forward and the training
   step (gradients of sum(out^2) in every input), each 3D pair held and
   timed at both;
5. DCNVideoNet at its published defaults (width 32, blocks (1, 1, 1), 400
   classes) on B=8 clips of 16x112x112, trained for a few AdamW steps by
   the in-package trainer; and DCNResNet3d-50 at the benchmark cell
   r3d50-k400-train's size (width 64, 400 classes, B=32 clips of
   16x112x112), trained the same way, every one of its 13 DCN layers
   (strided at c3_1, c4_1 and c5_1) on the 3D columns pair, the column
   kernels held against their plain versions on the layers' recorded
   inputs;
6. BASELINE config 5 (benchmarks/suite.py:64-70): the ResNet-50 stage
   sweep c3 / c4 / c5 (512 / 1024 / 2048 channels at 28x28 / 14x14 / 7x7,
   B=32, g = dg = 1, bias), forward and training step, on the fused
   gather pair or the unfused columns path (column kernels and a grouped
   cuBLAS product) as the card's fuse rule decides (the JAX package's
   `_fuse_ok` keeps c3 on the fused pair);
7. the 3D columns path: `modulated_deform_conv3d` at config 3's size
   (B=2, 64 -> 64, 16x32x32) with groups=2, dg=1, forward and training
   step, and `ModulatedDeformConv3dPack(groups=2)`;
8. the sharding layer's per-shard function (`sharding.shard_conv`) on
   every shard of six layouts at full width: config 2 split 4 ways on H
   and 2 x 2 on (H, W), config 5 c4 split 2 ways on H, configs 3 and 4
   (B=1) and the 3D columns case split 4 ways on D, max_offset 2: every
   shard's exchanged block cut from the global tensors, forward and
   backward: the single leading-dim splits of configs 2, 3 and 4 twice,
   on shift-blend's lead mode (rows 1, 4, 5, 6) and on the gather kernels'
   block mode (a given output grid and a tap gate at the global border),
   then under "auto", which must take the one the card's profile names;
   the other layouts under "auto", the gather kernels' block mode; the
   lead mode's
   kernels held against their plain versions in every mode, the gather
   passes against the same function on the plain path, the shards
   stitched against the unsharded kernel op, and the lead mode's shard
   step timed beside the gather
   kernels' on the same shard (`utils.profiling.Timer`, `annotate`,
   `trace`); and the public `sharded_modulated_deform_conv2d` on a
   one-rank NCCL mesh;
9. the device layer: `calibrate --quick` (the card's raw rates, and one
   point either side of each reference value of the dispatch rules, which
   must not contradict the committed profile; every time a captured,
   chain-differenced one, utils/graphs.py::time_chain), the smoke example
   through the kernels, and `autotune` of the column forward's knobs at
   config 5 c4 on the chain timer, every variant giving the same bits.
10. bf16 activations as they are (run_bf16): config 2 with bench.py's
   bf16 inputs on both pairs, configs 3 and 4 (B=1; B=4 for memory and
   time), config 5 c4 and the 3D columns case, in the three modes, each
   training step's out and gradients bit-equal to the upcast route's (the
   same entry on float32 copies), its launches the same, no
   activation-shaped copy on the fused and shift-blend paths (the columns
   path keeps its product's output cast, as in JAX), each kernel in bf16
   against its plain version, steps' peak memory and time both ways;
   `ModulatedDeformConv2dPack` at config 2 on bf16 input with fp32
   parameters; the cfg2-H4 interior shard on both sharded modes.
11. the captured steps (run_captured; utils/graphs.py, the counterpart of
   jax.jit): the public op's training step under "auto" at config 2
   (bounded and general, fp32 and bf16), config 3 (B=2, with and without
   its bound), config 5 c4 and the 3D columns case, each captured as a CUDA
   graph and replayed on a second seed's inputs, bit-equal (SHA-256) to
   eager; DCNResNet-50, DCNVideoNet and DCNResNet3d-50 (B=32) trained
   captured and eager from the same parameters, equal; the kernels each
   graph holds (all twelve among them; DCNResNet3d-50's 13 + 13 3D column
   launches, and each network's column launches over the column values
   its layer shapes give); every step eager against captured on the host clock, CUDA
   events, device time and the host's time to issue one call, and each op
   step's chain-differenced time (calibrate's and autotune's timer) beside
   its device time; each network's graph holds one launch of the AdamW
   update over every parameter value, and one launch of each GroupNorm
   kernel a norm over the values its norms hold.
12. the trainer's AdamW update (run_adamw; csrc/adamw.cu) on DCNResNet-50's
   187 leaves in float32 and bfloat16: the kernel against its plain
   version after two steps, one launch a step, and its captured,
   chain-differenced time beside its memory bound, torch's foreach AdamW
   (the path it replaced) and torch's fused AdamW (the library anchor).
13. GroupNorm with its ReLU and residual add (run_groupnorm;
   csrc/groupnorm.cu) at every norm of the benchmark's three cells
   (DCNResNet-50 at B=8 and B=1, DCNResNet3d-50 at B=32): the kernels
   against torch's GroupNorm, add and ReLU, and their captured,
   chain-differenced time, forward and forward with backward, beside
   torch's (the path they replaced) and their memory bound.

It builds the twelve kernels (shift-blend and gather, forward and
backward, 2D and 3D; the gather's columns forward and backward, 2D and
3D) from `modulated_deform_conv_tpu_torch/csrc/`, checks with the launch
table (`lib.counts`) that each path went through its kernels, holds each kernel
against its plain PyTorch version in every precision mode (at configs 2-5,
on small edge cases, and on the inputs and output cotangents that the DCN
layers of both networks saw at their first and last step), holds the
columns path against the fused pair, checks that the backward is bitwise
deterministic and that every kernel's unsharded launches give the bits of
the tree before the block mode (PREV_DIGESTS), times kernels, the grouped product, cuDNN's dense
convolution as an anchor, `grid_sample` as the columns' library yardstick
and steps with CUDA events (the config-2 steps also in device time), times
the 2D shift-blend forward's two routes side by side, both 3D pairs at
configs 3 and 4 side by side, and the DCN layers' kernels of both networks
on their recorded inputs beside their bounds (DCNResNet-50's forwards,
DCNVideoNet's forwards and backwards), and prints the kernel table as one
JSON line and a last line {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
It exits nonzero, and prints no result, without a CUDA device or without
the package beside it.  Imports nothing of JAX.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

B, C, O, H, W, KS, G, DG = 8, 256, 256, 56, 56, 3, 4, 4
BOUND = 2.0
# Kernel vs plain version, max|d| / max|ref| per precision mode.
LIMITS = {"float32": 1e-5,
          "tensorfloat32": 5e-3,   # 10-bit mantissa over a 576-long sum
          "bfloat16": 2e-2}
# H100 SXM published peaks (dense): bytes/s and operations/s per type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "tensorfloat32": 495e12, "bfloat16": 989e12}
MAIN_PRECISION = "tensorfloat32"   # the ops' default mode
TIMED_ITERS = 20
# DCNResNet training phase: depth 50 at its published width, B=8, 224x224.
RESNET = dict(width=64, classes=1000, batch=8, size=224, steps=6)
DCN_LAYERS = 13   # c3-c5 bottlenecks of depth 50: 4 + 6 + 3
REPLACES = {
    "shiftblend_fwd": "modulated_deform_conv_tpu/ops/pallas/shiftblend.py:627",
    "gathermm_fwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:1162",
    "shiftblend_bwd": "modulated_deform_conv_tpu/ops/pallas/shiftblend.py:970",
    "gathermm_bwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:1292",
    "shiftblend3d_fwd": "modulated_deform_conv_tpu/ops/pallas/shiftblend.py:719",
    "gathermm3d_fwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:1162",
    "shiftblend3d_bwd": "modulated_deform_conv_tpu/ops/pallas/shiftblend.py:1126",
    "gathermm3d_bwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:1292",
    "gathermm_cols_fwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:523",
    "gathermm_cols_bwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:623",
    "gathermm3d_cols_fwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:523",
    "gathermm3d_cols_bwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:623",
}
# BASELINE configs 3 and 4 (benchmarks/suite.py:58-63): 3x3x3, stride 1,
# pad 1, g = dg = 1, no bias, offsets U[-2, 2] passed with offset_bound=2.
# The JAX package's dispatch sends config 3 to planar gathermm and config 4
# to shift-blend; the port's "auto" takes the same kernels.
CFG3D = {
    "cfg3": dict(op="deform_conv3d", B=2, C=64, S=(16, 32, 32), in_step=64,
                 family="gathermm3d"),
    "cfg4": dict(op="modulated_deform_conv3d", B=4, C=128, S=(32, 64, 64),
                 in_step=2, family="shiftblend3d"),
}
BOUND3D = 2.0
# The plain versions hold every sample's columns and, in the backward,
# autograd's eight saved corner values at once (1.8 GB each per sample at
# config 4): at config 4 the kernels are held against them, and timed
# beside them, at B=1 with the config's other shapes.
PLAIN_BATCH = {"cfg3": 2, "cfg4": 1}
# (iters, per_sample, warmup) of time_ms for kernels and plain versions.
TIMING3D = {"cfg3": {"kernel": (20, 10, 3), "plain": (5, 2, 1)},
            "cfg4": {"kernel": (5, 2, 1), "plain": (2, 1, 1)}}
# DCNVideoNet at its published defaults (width 32, blocks (1, 1, 1), 400
# classes) on B=8 Kinetics-size clips of 16 x 112 x 112; its two DCN layers
# (s1b0: 64 ch at 16x56x56, s2b0: 128 ch at 16x28x28) run the 3D gather
# pair.
VIDEO = dict(width=32, classes=400, batch=8, frames=16, size=112, steps=4)
VIDEO_DCN_LAYERS = 2
# DCNResNet3d-50 at the benchmark cell r3d50-k400-train's size: published
# widths, 400 classes, B=32 Kinetics clips of 16 x 112 x 112; its 13 DCN
# layers (c3-c5, stride 2 on c3_1, c4_1 and c5_1) all take the 3D columns
# pair under "auto" at this batch.
RESNET3D = dict(width=64, classes=400, batch=32, frames=16, size=112, steps=3)
# BASELINE config 5 (benchmarks/suite.py:64-70): modulated_deform_conv2d at
# the ResNet-50 stage shapes, B=32, 3x3, stride 1, pad 1, g = dg = 1, zero
# bias, offsets U[-2, 2], mask U[0, 1], weights N(0, 0.05^2); per layer
# (channels, size); the pair "auto" takes follows the card's profile (the
# JAX package's `_fuse_ok` keeps c3 on the fused pair).
CFG5 = {"c3": (512, 28), "c4": (1024, 14), "c5": (2048, 7)}
CFG5_B = 32
# (iters, per_sample, warmup) of time_ms for config 5's plain path.
TIMING_PLAIN5 = (5, 2, 1)
# The 2D shift-blend forward's two routes (csrc/deform_fwd.cuh: the halo
# tile, or the corners from channels-last x), timed side by side at bound 2,
# B=8, 3x3, mask and bias: config 2, and g = dg = 1 planes from 56 x 56 down
# to DCNResNet-50's c3 and c4 sizes, on both sides of halo_route's 2048
# positions.  (label, C = O, (H, W), groups = deformable groups)
ROUTE_SHAPES = [("cfg2", 256, (56, 56), 4), ("56x56", 256, (56, 56), 1),
                ("48x48", 128, (48, 48), 1), ("32x32", 128, (32, 32), 1),
                ("28x28 (c3)", 128, (28, 28), 1), ("16x16", 256, (16, 16), 1),
                ("14x14 (c4)", 256, (14, 14), 1)]
# The columns path in 3D: config 3's size with two conv groups over one
# deformable group, modulated, with bias.
COLS3D = dict(B=2, C=64, S=(16, 32, 32), groups=2)
# Plain `deform_conv` main paths (no mask, no bias, offsets U[-2, 2], 3x3
# or 3x3x3, one group): BASELINE config 1 (benchmarks/suite.py:51-53), with
# its bound and without, and a small volume at config 3's op and channels.
# Under the H100 profile they are the main paths that take the fused
# gather pairs: the profile's columns path starts at 9.2e8 multiply-adds in
# 2D (config 2's general step and DCNResNet-50's layers are past it) and
# 4.5e8 in 3D (every 3D configuration above is past it); config 1's
# general step has 7.5e7, the small volume 2.3e8.
PLAIN_CASES = {"cfg1": dict(B=2, C=32, S=(64, 64)),
               "small volume": dict(B=2, C=64, S=(4, 16, 16))}
# The previous release's times on an NVIDIA H100 80GB HBM3 at 700 W
# ("tensorfloat32", ms): each table row's `ms`, at the row's own config (2D
# fused rows at config 2, 3D rows at configs 3 and 4 B=1, column rows at
# config 5 c4 and the 3D columns case), printed beside this run's; the
# column rows at config 5 c5 apart.
PREV_MS = {"shiftblend_fwd": 0.3563, "gathermm_fwd": 0.4025, "shiftblend_bwd": 0.9843,
           "gathermm_bwd": 1.0807, "shiftblend3d_fwd": 5.8381, "gathermm3d_fwd": 0.6279,
           "shiftblend3d_bwd": 16.3088, "gathermm3d_bwd": 2.2012, "gathermm_cols_fwd": 0.1503,
           "gathermm_cols_bwd": 0.3740, "gathermm3d_cols_fwd": 0.3171,
           "gathermm3d_cols_bwd": 0.9626}
PREV_MS_C5 = {"gathermm_cols_fwd": 0.0881, "gathermm_cols_bwd": 0.2257}
# Config 5 c3's column forward called directly (this script's previous
# release; its backward was not timed then).
PREV_MS_C3 = {"gathermm_cols_fwd": 0.2337}
# SHA-256 of the columns the column forward gave before its two routes (one
# thread per (sample, group, tap, position), 32 channels a block; nvcc 12.9,
# sm_90a, NVIDIA H100 80GB HBM3) on config 5's c3-c5 inputs and the 3D
# columns case's, per mode: printed beside this run's, which the routes keep.
PREV_COLS_FWD_DIGESTS = {
    "c3": {"float32": "9982825f5895bdd99635cebecf24beb2079ff3deeb81cabc36d12d98a919b0e7",
           "bfloat16": "2790e81606d1aaeec6b46527f1ae235302d82272c0c5ea06846b9936dda720f2"},
    "c4": {"float32": "4d1ec3aac038bdc90b6098087ec2d128f2a1b8c5e5f856eafb0b6b6cabc7bfc8",
           "bfloat16": "4afc267b276a448af1931444accf8abe3c669732262523f9e53118ab7d2bc494"},
    "c5": {"float32": "5333ed5ad2bc27c0c6d49b1dd125c3164eb8013b98162473d3188c232ee43155",
           "bfloat16": "6c5d655eb106fa4c40c86b9d44bfa2d6fef1fb02702d6fa957d1e6f501b006e2"},
    "3d": {"float32": "3d80663eed3a55d0effb2d84c8b70e07a401e01fd78ff4a692ad5a1459b25fb0",
           "bfloat16": "4bb42d7bd493a97b2b47c8bc23ddc496fc0ea8ffcb3daef1904abaa7c5c2dd45"}}
# The same release's steps and totals (ms): the config-2 training steps on
# CUDA events, the networks' step device time and their DCN kernels (from
# the step's profile), the device time of DCNResNet-50's 13 gathermm_fwd
# calls on their recorded inputs, and config 5 c3's forward op.
PREV_STEP_MS = {"cfg2 bounded": 2.9075, "cfg2 general": 2.7959,
                "DCNResNet-50 device": 12.774, "DCNResNet-50 DCN kernels": 3.971,
                "DCNResNet-50 gathermm_fwd": 1.0975, "cfg5 c3 op_fwd": 2.5898,
                "DCNVideoNet device": 96.287, "DCNVideoNet DCN kernels": 40.662,
                "cfg3 step": 3.5116, "cfg4 step": 85.9156}


# The sharded phase: the per-shard function of the sharding layer
# (`sharding.shard_conv`) on every shard's exchanged block, cut from the
# global tensors, at full width: (the inputs, {spatial dim: shards}), with
# max_offset 2 (a halo of 3 rows) and offsets from U[-2, 2].  Under "auto"
# the single leading-dim splits of the narrow slabs (configs 2, 3 and 4,
# C/dg <= 128) run shift-blend's lead mode (LEAD_LAYOUTS), the others the
# gather kernels' block mode; LEAD_LAYOUTS run again at impl="cuda", the
# fused gather pair in block mode.  Config 4 at B=1, as its plain checks.
SHARDED = {"cfg2-H4": ("cfg2", {0: 4}), "cfg2-HW2x2": ("cfg2", {0: 2, 1: 2}),
           "c4-H2": ("c4", {0: 2}), "cfg3-D4": ("cfg3", {0: 4}),
           "cfg4-D4": ("cfg4", {0: 4}), "cols3d-D4": ("cols3d", {0: 4})}
LEAD_LAYOUTS = ("cfg2-H4", "cfg3-D4", "cfg4-D4")
SHARD_MAX_OFFSET = 2.0
GATHER_ROWS = ("gathermm_fwd", "gathermm_bwd", "gathermm3d_fwd", "gathermm3d_bwd",
               "gathermm_cols_fwd", "gathermm_cols_bwd", "gathermm3d_cols_fwd",
               "gathermm3d_cols_bwd")
LEAD_ROWS = ("shiftblend_fwd", "shiftblend_bwd", "shiftblend3d_fwd", "shiftblend3d_bwd")
# (samples, calls a sample) of the lead-mode layouts' shard step timings.
LEAD_TIMING = (7, 3)
# SHA-256 of every kernel's unsharded outputs (`unsharded_digests`: its
# row's config, seeded cotangents, every mode) as the tree before the
# gather kernels' block mode gave them (nvcc 12.8, sm_90a, NVIDIA H100 80GB
# HBM3; tools/compare_parent_kernels.py): the default gate (-1, S) must
# change no bit.
PREV_DIGESTS = {
    "shiftblend_fwd": {
        "float32": "5ffc0e4fc39aaeeb0a6388e9892e1ed281a505f02fa61f70dadfa63c5ee38a8a",
        "tensorfloat32": "c7ee8bbb1d7180e6f534543f55aa64e75663389a43adef341afc6f0592b2942b",
        "bfloat16": "545d84b5075bdd40ab5d6fa06a46b505f18cd996ddbeb1d6766496f3a72e4af6"},
    "shiftblend_bwd": {
        "float32": "ddce7a9ff4deb8355e4b66c5cbfee767c9c4c18029f8cd1ece3590efefffeb12",
        "tensorfloat32": "18fe3b62c92a337076390bb2da78dddbc0a23ca072e0d96caa678a05e5b45058",
        "bfloat16": "13421bc9c8918b268ae5f771aa135152b85938f3ee622ada9bde3c0223726022"},
    "gathermm_fwd": {
        "float32": "5ffc0e4fc39aaeeb0a6388e9892e1ed281a505f02fa61f70dadfa63c5ee38a8a",
        "tensorfloat32": "c7ee8bbb1d7180e6f534543f55aa64e75663389a43adef341afc6f0592b2942b",
        "bfloat16": "545d84b5075bdd40ab5d6fa06a46b505f18cd996ddbeb1d6766496f3a72e4af6"},
    "gathermm_bwd": {
        "float32": "a19499383e32b1b8550f9dcc6c030aa80648b8afd06b5bf2be8c6fcc05b2b159",
        "tensorfloat32": "fe67fd281dea1f67977788bb8fcc2cea9441a75422f455603f9d9a2ecf0f3835",
        "bfloat16": "af94404c8f63f141857472ad9d24187c791574feb38baeb6e840e9cd008aba01"},
    "gathermm3d_fwd": {
        "float32": "cdef836ed67e26651bd9dfe1b4690e25ab358a6a7f6a23b5b80c3a0ae59505c7",
        "tensorfloat32": "f52d219c02ac61f5df0b288f54c840d36aa44e98d14ddae27cbd44124335d580",
        "bfloat16": "fb066b5e03e78aef6ffddf3580c04888cd8dba1761cba47295d51508fb839d32"},
    "gathermm3d_bwd": {
        "float32": "25756ea014491ba729af9bf3b8511440ea057d8eae64e5ad52325583f2707bce",
        "tensorfloat32": "eaf72b5f3ae65aa2a65275a559670f4be21fb7f17d24af19c8dfb5c147cf56ce",
        "bfloat16": "4df589eec2b97c474b2ef4ac8142dd38e42f14101dde93f20c6ae1cbf8531ba3"},
    "shiftblend3d_fwd": {
        "float32": "9dfb48c312620babc069a1a5673ffa64ed2999b1470e5c4aea7892289829c68d",
        "tensorfloat32": "90c5d6fedeb76921c3c4c8914e5e21cacb334b29343b31f2efe6baf3fcebd5b5",
        "bfloat16": "1970824ed5273c19bfc0a1e7ea4d74bc282e77ca58c21206ac02d33b809d5eb1"},
    "shiftblend3d_bwd": {
        "float32": "60c7070702718f94d71df1438bb5be0ec6ae15615169b6d586417e546c4f064d",
        "tensorfloat32": "50cd9fa9b772cc299aa79b2317a50be186c0558771b224264b3322102c873010",
        "bfloat16": "aa282e87c1fdc8804eaf928e669545c62287ea8366fc9f92c89bc3a57734822e"},
    "gathermm_cols_fwd": {
        "float32": "4d1ec3aac038bdc90b6098087ec2d128f2a1b8c5e5f856eafb0b6b6cabc7bfc8",
        "tensorfloat32": "4d1ec3aac038bdc90b6098087ec2d128f2a1b8c5e5f856eafb0b6b6cabc7bfc8",
        "bfloat16": "4afc267b276a448af1931444accf8abe3c669732262523f9e53118ab7d2bc494"},
    "gathermm_cols_bwd": {
        "float32": "89ef6b18d72776d88a1d236a969112ded67560c8cd8ac6ae58436c7bd3d0cd82",
        "tensorfloat32": "89ef6b18d72776d88a1d236a969112ded67560c8cd8ac6ae58436c7bd3d0cd82",
        "bfloat16": "bcdecf0f7aab3efc242d8c5efe450a48469b33a13acdb6a84b2e70109044aef5"},
    "gathermm3d_cols_fwd": {
        "float32": "3d80663eed3a55d0effb2d84c8b70e07a401e01fd78ff4a692ad5a1459b25fb0",
        "tensorfloat32": "3d80663eed3a55d0effb2d84c8b70e07a401e01fd78ff4a692ad5a1459b25fb0",
        "bfloat16": "4bb42d7bd493a97b2b47c8bc23ddc496fc0ea8ffcb3daef1904abaa7c5c2dd45"},
    "gathermm3d_cols_bwd": {
        "float32": "37fe2abe8e94961545d77b8724c03cfddc3f99bb1eb59dc7c9377d37aad0330b",
        "tensorfloat32": "37fe2abe8e94961545d77b8724c03cfddc3f99bb1eb59dc7c9377d37aad0330b",
        "bfloat16": "1d222706686afd1bdf7de20f6edb6cc5ad482174532ec74f2e9781c906d51955"}}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got, ref):
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def time_ms(fn, iters=TIMED_ITERS, per_sample=10, warmup=3):
    """Median over `iters` samples of the time of one fn() call, each sample
    CUDA events around `per_sample` back-to-back calls (so the host's
    enqueue of one call overlaps the device's run of the previous)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def host_ms(fn, calls=10, samples=5):
    """Median over `samples` of the host's time to issue one fn() call, in
    ms: the wall clock around `calls` back-to-back calls with no
    synchronisation inside, the device idle at the start of each sample."""
    import torch
    fn()
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def cfg2_inputs(torch, dev, seed=0):
    """bench.py's config-2 inputs (bench.py:212-221), seeded with numpy."""
    K = KS * KS
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, C, H, W)).astype(f32)
    off = rng.uniform(-2, 2, (B, DG * 2 * K, H, W)).astype(f32)
    mask = rng.uniform(0, 1, (B, DG * K, H, W)).astype(f32)
    w = (rng.standard_normal((O, C // G, KS, KS)) * 0.05).astype(f32)
    bias = np.zeros((O,), f32)
    return [torch.from_numpy(a).to(dev) for a in (x, off, mask, w, bias)]


def small_cases(torch, dev):
    """Small configs with ragged tiles, offsets far beyond the bound (partial
    and full corner drops) and far outside the image, all-zero offsets (the
    integer grid), no mask / no bias, stride and dilation, and deformable
    groups straddling conv groups; each with a cotangent for the
    backward."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    rng = np.random.default_rng(1)
    cases = []
    # name, kernel, (B, C, O, H, W, k, stride, pad, dil, g, dg), modulated,
    # bias, offset scale, bound
    table = [
        ("shiftblend", (2, 32, 48, 13, 11, 3, 1, 1, 1, 2, 4), True, True, 4.0, 1.5),
        ("shiftblend", (1, 16, 16, 9, 9, 3, 1, 2, 2, 1, 2), False, False, 5.0, 2.0),
        # 5x5 taps at bound 1.5: 625 (tap, window) pairs, within the 640 a 2D
        # config may unroll (past them the JAX package, and the port, refuse
        # shift-blend in 2D).
        ("shiftblend", (2, 64, 80, 10, 19, 5, 1, 2, 1, 2, 2), True, True, 3.0, 1.5),
        ("shiftblend", (2, 32, 32, 12, 12, 3, 1, 1, 1, 1, 1), True, True, 0.0, 2.0),
        ("gathermm", (2, 32, 48, 13, 11, 3, 2, 1, 1, 1, 4), True, True, 6.0, None),
        ("gathermm", (1, 12, 8, 9, 7, 3, 1, 2, 2, 2, 3), False, False, 2.0, None),
        ("gathermm", (2, 64, 130, 20, 17, 3, 1, 1, 1, 2, 1), True, False, 1.5, None),
        ("gathermm", (2, 16, 16, 9, 7, 3, 1, 1, 1, 1, 2), True, True, 40.0, None),
        ("gathermm", (2, 32, 32, 12, 12, 3, 2, 1, 1, 1, 1), True, True, 0.0, None),
    ]
    for name, (b, c, o, h, w_, k, s, p, d, g, dg), modulated, with_bias, scale, bound in table:
        spec = DeformConvSpec.make(2, k, s, p, d, g, dg, modulated=modulated)
        oh, ow = spec.out_sizes((h, w_))
        K = k * k
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        x = t(rng.standard_normal((b, c, h, w_)))
        off = t(rng.uniform(-scale, scale, (b, dg * 2 * K, oh, ow)))
        mask = t(rng.uniform(0, 1, (b, dg * K, oh, ow))) if modulated else None
        wt = t(rng.standard_normal((o, c // g, k, k)) * 0.1)
        bias = t(rng.standard_normal((o,))) if with_bias else None
        gout = t(rng.standard_normal((b, o, oh, ow)))
        cases.append((name, spec, (x, off, mask, wt, bias), gout, bound))
    return cases


def launched(c):
    """The kernels a run of the counters launched, with their counts."""
    return {n: v for n, v in c.items() if v}


def entry_of(fn, ndim):
    """The C entry the kernel wrapper `fn` launches at rank `ndim`, as the
    launch table names it: "gathermm3d_fwd" for gathermm.fused_fwd in 3D,
    "shiftblend_bwd" for shiftblend.bwd in 2D."""
    family = fn.__module__.rsplit(".", 1)[1] + ("3d" if ndim == 3 else "")
    return f"{family}_{fn.__name__.removeprefix('fused_')}"


def auto_pair(x, spec, O, bound=None):
    """The kernel pair "auto" takes for input x on the card, as the device
    profile of x's card decides (utils/device.py): "shiftblend" or
    "gathermm" (the fused pair) or "gathermm_cols" (the columns path), with
    "3d" after the family name in 3D."""
    from modulated_deform_conv_tpu_torch.ops.cuda import plan, select_kernel
    name, reason = select_kernel(x, spec, bound)
    check(name is not None, f"no kernel takes {tuple(x.shape)}: {reason}")
    d = "3d" if spec.ndim == 3 else ""
    if name == "shiftblend":
        return f"shiftblend{d}"
    return f"gathermm{d}" if plan.fuse_ok(x, spec, O) else f"gathermm{d}_cols"


def current_profile_of(x):
    """The device profile of x's card."""
    from modulated_deform_conv_tpu_torch.utils.device import current_profile
    return current_profile(x)


def col_values(torch, model, x):
    """The column values one forward of `model` on x has the column forward
    write, by C entry ("gathermm_cols_fwd", "gathermm3d_cols_fwd"), from
    the shapes of each DCN layer that "auto" sends to the column pair: C x
    taps x B x the output grid."""
    total, hooks = {}, []

    def hook(mod, inputs, out):
        xin = inputs[0]
        pair = auto_pair(xin, mod._spec(), mod.weight.shape[0], mod.offset_bound)
        if pair.endswith("_cols"):
            grid = out.shape[:1] + out.shape[2:]
            total[f"{pair}_fwd"] = (total.get(f"{pair}_fwd", 0) + xin.shape[1]
                                    * math.prod(mod.kernel_size) * math.prod(grid))

    for m in model.modules():
        if hasattr(m, "_spec"):
            hooks.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total


def recorded_pairs(recorded, steps, kernels):
    """The launches a trainer's run must make: per DCN layer recorded at
    the first step, `steps` of its "auto" pair's forward and backward."""
    want = {n: 0 for n in kernels}
    for rec in recorded:
        if rec["step"] == 0:
            xs, ws = rec["ins"][0], rec["ins"][3]
            fam = auto_pair(xs, rec["spec"], ws.shape[0])
            want[f"{fam}_fwd"] += steps
            want[f"{fam}_bwd"] += steps
    return want


def grad_rel_errs(got, want):
    """Per-gradient relative error of a backward kernel against its plain
    version (None where the gradient does not exist)."""
    return {n: None if r is None else rel_err(g, r)
            for n, g, r in zip(("x", "offset", "mask", "weight"), got, want)}


def max_abs(got, want):
    return max(float((g - r).abs().max()) for g, r in zip(got, want)
               if r is not None)


def device_time_by_kernel(fn, calls=3):
    """Device time per call of each CUDA kernel that `calls` runs of fn()
    launch, in ms, from torch.profiler; {} if the trace holds no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not e.is_user_annotation):   # annotations double-count
            times[e.key] = e.self_device_time_total / 1e3 / calls
    return times


def kernel_split(times):
    """Device time per call by kernel (device_time_by_kernel), keyed by the
    kernel's short name (no namespace, arguments or return type), largest
    first."""
    short = {}
    for key, ms in times.items():
        name = key.split("(")[0].replace("void ", "").replace("mdc::", "").strip()
        short[name] = short.get(name, 0.0) + ms
    return dict(sorted(short.items(), key=lambda kv: -kv[1]))


def print_breakdown(label, times, top=8):
    if not times:
        print(f"{label}: device time not measured (the trace held none)")
        return
    total = sum(times.values())
    print(f"{label}: {total:.4f} ms of device time per call")
    for key, ms in sorted(times.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.4f} ms {100 * ms / total:5.1f}%  {key[:90]}")


def train_recorded(torch, train, pack_cls, spec_cls, steps, **train_kw):
    """Train on the card with the in-package trainer while hooks on every
    `pack_cls` layer record, at the first step (zero-init offsets: every tap
    on the integer grid) and the last, the layer's inputs and output
    cotangent; recording launches nothing.  Returns the trainer's result and
    the records."""
    check_steps = (0, steps - 1)
    recorded, hooks, at = [], [], {"step": None}

    def record(name):
        def hook(mod, inputs, out):
            if at["step"] not in check_steps:
                return
            xin = inputs[0]
            with torch.no_grad():
                p_mask = mod.conv_mask(xin)
                ins = (xin, mod.conv_offset(xin),
                       torch.sigmoid(p_mask) if mod.sigmoid_mask else p_mask, mod.weight)
            rec = {"step": at["step"], "name": name, "spec": spec_cls.make(
                mod._ndim, mod.kernel_size, mod.stride, mod.padding, mod.dilation, mod.groups,
                mod.deformable_groups, mod.in_step, modulated=True),
                "ins": [t.detach().clone(memory_format=torch.contiguous_format) for t in ins]}
            out.register_hook(lambda g: rec.update(
                gout=g.detach().clone(memory_format=torch.contiguous_format)))
            recorded.append(rec)
        return hook

    def on_step(step, model):
        at["step"] = step
        if step == 0:
            hooks.extend(m.register_forward_hook(record(n)) for n, m in model.named_modules()
                         if isinstance(m, pack_cls))

    res = train(steps=steps, device="cuda", log=lambda s: print(f"  {s}"), on_step=on_step,
                eager=True, **train_kw)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return res, recorded


def check_recorded(torch, recorded, layers, pair, label):
    """Hold a kernel pair against its plain versions, every mode, on the
    recorded inputs and cotangents of every DCN layer."""
    fwd, fwd_ref, bwd, bwd_ref = pair
    check(len(recorded) == 2 * layers and all("gout" in rec for rec in recorded),
          f"{label}: recorded {len(recorded)} DCN layer calls, want {layers} x 2")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for rec in recorded:
            xs, offs, masks, ws = rec["ins"]
            gout = rec["gout"]
            sspec, max_off = rec["spec"], float(offs.abs().max())
            if rec["step"] == 0:
                check(max_off == 0.0, f"{label} {rec['name']}: first-step offsets not zero")
            worst = {}
            for prec, limit in LIMITS.items():
                args = (xs, offs, masks, ws, None, sspec, prec)
                errs = {"out": rel_err(fwd(*args), fwd_ref(*args))}
                bargs = (xs, offs, masks, ws, gout, sspec, prec)
                errs.update(grad_rel_errs(bwd(*bargs), bwd_ref(*bargs)))
                for n, e in errs.items():
                    check(e <= limit, f"{label} step {rec['step']} {rec['name']} {prec} "
                          f"{'out' if n == 'out' else 'grad_' + n}: rel err {e:.3e}")
                worst[prec] = max(errs.values())
            print(f"{label} step {rec['step']} {rec['name']} x {tuple(xs.shape)} "
                  f"stride {sspec.stride[0]} max|off| {max_off:.3g}: {entry_of(fwd, sspec.ndim)} + bwd vs "
                  "plain, worst rel err " + " ".join(f"{p} {e:.2e}" for p, e in worst.items()))
    print(f"{label} layer checks: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def run_resnet3d(torch, mdt, train, gm, spec_cls, reset, counts, kernels):
    """DCNResNet3d-50 (RESNET3D) trained eagerly by the in-package trainer,
    hooks recording each DCN layer's inputs at the first and last step:
    every layer's launches are the 3D column pair's, one each way a step,
    and the column kernels are held against their plain versions on every
    record.  Returns the launches."""
    r = RESNET3D
    reset()
    res, recorded = train_recorded(
        torch, train, mdt.ModulatedDeformConv3dPack, spec_cls, r["steps"], batch=r["batch"],
        width=r["width"], classes=r["classes"], size=r["size"], arch="resnet3d",
        frames=r["frames"])
    launches = counts()
    print(f"DCNResNet3d-50 launches over {r['steps']} steps: {launched(launches)}")
    check(len([rec for rec in recorded if rec["step"] == 0]) == DCN_LAYERS,
          "DCNResNet3d-50: not every DCN layer recorded")
    want = recorded_pairs(recorded, r["steps"], kernels)
    cols = {f"gathermm3d_cols_{k}": DCN_LAYERS * r["steps"] for k in ("fwd", "bwd")}
    check(launches == want and launched(want) == cols,
          f"DCNResNet3d-50 launches {launched(launches)}, want the profile's pairs "
          f"{launched(want)} and the 3D column pair on every layer {cols}")
    check(all(np.isfinite(res["losses"])), f"DCNResNet3d-50 loss not finite: {res['losses']}")
    strides = sorted({rec["spec"].stride[0] for rec in recorded})
    print(f"DCNResNet3d-50 width {r['width']} {r['classes']} classes B={r['batch']} "
          f"{r['frames']}x{r['size']}x{r['size']}: loss {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f}, step {statistics.median(res['step_s'][1:]) * 1e3:.2f} ms "
          f"(median of steps 2-{r['steps']}, eager); DCN strides {strides}")
    check(strides == [1, 2], f"DCNResNet3d-50: DCN strides {strides}, want 1 and 2")
    check_recorded_cols(torch, recorded, gm, "DCNResNet3d-50")
    return launches


def check_recorded_cols(torch, recorded, gm, label, batch=2):
    """Hold the column pair of the layers' rank against its plain versions,
    every mode, on the first `batch` samples of every DCN layer's recorded
    inputs (the plain versions hold every corner of the columns at once),
    with a seeded cotangent of the columns."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for rec in recorded:
            xs, offs, masks = (t[:batch].contiguous() for t in rec["ins"][:3])
            sspec = rec["spec"]
            fwd, bwd = gm.cols_fwd, gm.cols_bwd
            names = (entry_of(fwd, sspec.ndim), entry_of(bwd, sspec.ndim))
            worst = {}
            for prec, limit in LIMITS.items():
                got = fwd(xs, offs, masks, sspec, prec)
                errs = [rel_err(got, gm.gathermm_cols_reference(xs, offs, masks, sspec, prec))]
                gcols = torch.randn(got.shape, generator=gen, device=xs.device).to(got.dtype)
                del got
                errs += [rel_err(a, r) for a, r in zip(
                    bwd(xs, offs, masks, gcols, sspec, prec),
                    gm.gathermm_cols_bwd_reference(xs, offs, masks, gcols, sspec, prec))
                    if r is not None]
                worst[prec] = max(errs)
                check(worst[prec] <= limit, f"{label} step {rec['step']} {rec['name']} {prec}: "
                      f"{names[0]} / {names[1]} vs plain, rel err {worst[prec]:.3e}")
                del gcols
            print(f"{label} step {rec['step']} {rec['name']} x {tuple(xs.shape)} (first {batch} "
                  f"samples): {names[0]} + {names[1]} vs plain, worst rel err "
                  + " ".join(f"{p} {e:.2e}" for p, e in worst.items()))


DCN_KERNELS = ("fwd_mma_kernel", "fold_out_kernel", "ranges_kernel", "boxes3_kernel", "gx_kernel",
               "gx3_kernel", "goff_kernel", "goff3_kernel", "fold_kernel", "cols_plane_kernel",
               "cols_gather_kernel", "x_cl_kernel", "gcols_mma_kernel", "gw_mma_kernel", "corr_kernel",
               "boxes_kernel", "pull_kernel", "pull3_kernel", "corr3_kernel", "col_")


def time_recorded(torch, recorded, fwd, label, bwd=None):
    """The forward kernel's time (main precision) on each DCN layer's inputs
    recorded at the trainer's last step, and the backward kernel's on the
    recorded cotangent where `bwd` is given, each beside the layer's bound:
    CUDA events around back-to-back calls (where a call's host work
    outlasts its device work, this is the host's time) and the device time
    of the kernels one call launches (torch.profiler); and the device memory
    a call allocates at its peak.  Returns the sums (ms) over the layers,
    per kind."""
    last = max(rec["step"] for rec in recorded)
    kinds = {"fwd": fwd} if bwd is None else {"fwd": fwd, "bwd": bwd}
    total = {kind: {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0} for kind in kinds}
    with torch.no_grad():
        for rec in recorded:
            if rec["step"] != last:
                continue
            xs, offs, masks, ws = rec["ins"]
            n_out = rec["gout"].numel()
            w = work((xs, offs, masks, ws, None), n_out, rec["spec"])
            for kind, fn in kinds.items():
                fifth = None if kind == "fwd" else rec["gout"]
                args = (xs, offs, masks, ws, fifth, rec["spec"], MAIN_PRECISION)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                fn(*args)
                torch.cuda.synchronize()
                peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
                ms = time_ms(lambda: fn(*args))
                device_ms = sum(device_time_by_kernel(lambda: fn(*args), calls=5).values())
                bound_ms, bound_by = bound_of(*w[kind])
                for key, v in (("ms", ms), ("device_ms", device_ms), ("bound_ms", bound_ms)):
                    total[kind][key] += v
                print(f"{label} {rec['name']} x {tuple(xs.shape)} stride {rec['spec'].stride[0]}: "
                      f"{entry_of(fn, rec['spec'].ndim)} {ms:.4f} ms (device {device_ms:.4f} ms), bound {bound_ms:.4f} ms "
                      f"({bound_by}; {w[kind][1] / 1e9:.1f} GFLOP); peak {peak_gb:.2f} GB above its "
                      "inputs")
    nd = recorded[0]["spec"].ndim
    for kind, fn in kinds.items():
        prev = PREV_STEP_MS.get(f"{label} {entry_of(fn, nd)}")
        print(f"{label}: {entry_of(fn, nd)} summed over its layers {total[kind]['ms']:.4f} ms, device "
              f"{total[kind]['device_ms']:.4f} ms, summed bound {total[kind]['bound_ms']:.4f} ms"
              + ("" if prev is None else f" (previous release: {prev} ms of device time)"))
    return total


def profile_train_step(res, train_step, label):
    """Where the device time of one of the trainer's own steps goes."""
    x, y = res["batch"]
    prof = device_time_by_kernel(lambda: train_step(res["model"], res["optimizer"], x, y))
    print_breakdown(f"{label} step profile", prof, top=12)
    if prof:
        dcn_ms = sum(ms for k, ms in prof.items() if any(o in k for o in DCN_KERNELS))
        prev = (f" (previous release: {PREV_STEP_MS[label + ' DCN kernels']} of "
                f"{PREV_STEP_MS[label + ' device']} ms)" if label + " device" in PREV_STEP_MS else "")
        print(f"{label} step: the port's DCN kernels {dcn_ms:.3f} ms of "
              f"{sum(prof.values()):.3f} ms device time{prev}")


def time_routes(torch, sb, dev):
    """Both routes of the 2D shift-blend forward at ROUTE_SHAPES, each held
    against the plain version in the main precision and timed; prints which
    route `halo_route` picks and whether it was the faster here."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    rng = np.random.default_rng(5)
    out = {}
    with torch.no_grad():
        for label, c, hw, g in ROUTE_SHAPES:
            spec = DeformConvSpec.make(2, KS, 1, 1, 1, g, g, modulated=True)
            K = KS * KS
            t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
            ins = (t(rng.standard_normal((B, c) + hw)),
                   t(rng.uniform(-2, 2, (B, g * 2 * K) + hw)),
                   t(rng.uniform(0, 1, (B, g * K) + hw)),
                   t(rng.standard_normal((c, c // g, KS, KS)) * 0.05),
                   t(rng.standard_normal((c,))))
            want = sb.shiftblend_fwd_reference(*ins, spec, MAIN_PRECISION, BOUND)
            ms = {}
            for route, halo in (("halo", True), ("xt", False)):
                def run(halo=halo):
                    return sb.fwd(*ins, spec, MAIN_PRECISION, BOUND, halo=halo)
                e = rel_err(run(), want)
                check(e <= LIMITS[MAIN_PRECISION], f"shiftblend_fwd {route} route at {label}: rel err {e:.3e}")
                ms[route] = time_ms(run)
            pick = "halo" if sb.halo_route(hw) else "xt"
            faster = min(ms, key=ms.get)
            print(f"shiftblend_fwd route at {label} (B={B}, {c} ch, {hw[0]}x{hw[1]}, g = dg = {g}): "
                  f"halo {ms['halo']:.4f} ms, xt {ms['xt']:.4f} ms; halo_route picks {pick}"
                  f"{'' if pick == faster else ' (the slower here)'}")
            out[label] = {**ms, "pick": pick}
    return out


def cfg3d_inputs(torch, dev, name, seed=0):
    """A 3D config's spec and inputs (x, offset, mask or None, weight, bias
    None) as benchmarks/suite.py builds them, from a numpy seed."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    c = CFG3D[name]
    modulated = c["op"].startswith("modulated")
    B, C, S, K = c["B"], c["C"], c["S"], 27
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, C) + S).astype(f32)
    off = rng.uniform(-2, 2, (B, 3 * K) + S).astype(f32)
    mask = rng.uniform(0, 1, (B, K) + S).astype(f32) if modulated else None
    w = (rng.standard_normal((C, C, 3, 3, 3)) * 0.05).astype(f32)
    spec = DeformConvSpec.make(3, 3, 1, 1, 1, 1, 1, c["in_step"], modulated)
    return spec, tuple(None if a is None else torch.from_numpy(a).to(dev)
                       for a in (x, off, mask, w, None))


def op3d(mdt, name, ins, **kw):
    """The config's public op (deform_conv3d or modulated_deform_conv3d)."""
    c = CFG3D[name]
    x, off, mask, w, bias = ins
    args = (x, off) + (() if mask is None else (mask,)) + (w, bias)
    return getattr(mdt, c["op"])(*args, 1, 1, 1, 1, 1, c["in_step"], **kw)


def refill(ins, leaves):
    it = iter(leaves)
    return tuple(None if t is None else next(it) for t in ins)


def plain_case_inputs(torch, dev, name, seed=0):
    """A PLAIN_CASES case's spec and inputs (x, offset, weight), seeded
    with numpy as benchmarks/suite.py builds them."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    c = PLAIN_CASES[name]
    nd = len(c["S"])
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((c["B"], c["C"]) + c["S"]).astype(f32)
    off = rng.uniform(-2, 2, (c["B"], nd * 3 ** nd) + c["S"]).astype(f32)
    w = (rng.standard_normal((c["C"], c["C"]) + (3,) * nd) * 0.05).astype(f32)
    spec = DeformConvSpec.make(nd, 3, 1, 1, 1, 1, 1, modulated=False)
    return spec, [torch.from_numpy(a).to(dev) for a in (x, off, w)]


def plain_case_op(mdt, spec):
    """The case's public op on (x, offset, weight), without bias."""
    fn = mdt.deform_conv2d if spec.ndim == 2 else mdt.deform_conv3d
    return lambda x, off, w, **kw: fn(x, off, w, None, 1, 1, 1, 1, 1, **kw)


def run_plain_cases(torch, mdt, reset, counts, dev):
    """The PLAIN_CASES main paths through the public op under "auto": per
    case and bound (config 1 with its bound 2 and without, the small volume
    without), the forward without gradients and one training step (grads
    of sum(out^2) in x, offset and weight), which must launch the pair the
    card's profile names, its forward twice and its backward once, and
    nothing else; out and the three gradients against impl="torch".
    Returns {label: launches}."""
    out = {}
    for name, bounds in (("cfg1", (BOUND, None)), ("small volume", (None,))):
        spec, ins = plain_case_inputs(torch, dev, name)
        x, off, w = ins
        fn = plain_case_op(mdt, spec)
        macs = x.shape[0] * math.prod(x.shape[2:]) * w.shape[0] * x.shape[1] * spec.tap_count
        for bound in bounds:
            label = f"{name} {'bounded' if bound else 'general'}"
            pair = auto_pair(x, spec, w.shape[0], bound)
            kw = dict(offset_bound=bound)
            reset()
            with torch.no_grad():
                y0 = fn(*ins, impl="auto", **kw)
            leaves = [t.clone().requires_grad_(True) for t in ins]
            y = fn(*leaves, impl="auto", **kw)
            grads = torch.autograd.grad((y * y).sum(), leaves)
            torch.cuda.synchronize()
            c = launched(counts())
            check(c == {f"{pair}_fwd": 2, f"{pair}_bwd": 1},
                  f"{label}: launched {c}, want {pair}'s forward twice and backward once")
            ref_leaves = [t.clone().requires_grad_(True) for t in ins]
            yr = fn(*ref_leaves, impl="torch", **kw)
            errs = {"out": rel_err(y0, yr.detach())}
            errs.update({n: rel_err(g, r) for n, g, r in zip(
                ("x", "offset", "weight"), grads,
                torch.autograd.grad((yr * yr).sum(), ref_leaves))})
            check(y0.shape == yr.shape and bool(torch.isfinite(y0).all())
                  and all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: bad output")
            for n, e in errs.items():
                check(e <= LIMITS[MAIN_PRECISION], f"{label} {n} vs impl='torch': {e:.3e}")
            print(f"{label} (x {tuple(x.shape)}, {macs:.3e} multiply-adds) under 'auto': {pair}, "
                  f"launches {c}; vs impl='torch' " + " ".join(f"{n} {e:.2e}" for n, e in errs.items()))
            out[label] = c
            del y0, y, grads, yr, leaves, ref_leaves
    return out


def small_cases3(torch, dev):
    """Small 3D configs with ragged 4 x 4 x 4 bricks, offsets beyond the
    bound and far outside the volume, all-zero offsets, no mask / no bias,
    stride 2, deformable groups straddling conv groups, dg > 1 with
    groups > 1, 2 x 2 x 2 taps at bound 0.5 (at most 640 pairs), a 5 x 5 x
    5 kernel at bound 1 and one without a bound, and 10 channels a
    deformable group (the 4-byte column builds); each with a cotangent for
    the backward."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    rng = np.random.default_rng(1)
    # family, (B, C, O, S, k, stride, pad, dil, g, dg), modulated, bias,
    # offset scale, bound
    table = [
        ("shiftblend3d", (2, 16, 24, (5, 64, 6), 3, 1, 1, 1, 2, 2), True, True, 2.5, 2.0),
        ("shiftblend3d", (1, 16, 16, (6, 8, 16), 3, 1, 2, 2, 1, 2), False, False, 3.0, 1.0),
        ("shiftblend3d", (2, 32, 32, (4, 9, 7), 2, 1, 1, 2, 1, 1), True, True, 0.45, 0.5),
        ("shiftblend3d", (2, 16, 16, (5, 8, 16), 3, 1, 1, 1, 1, 1), True, True, 0.0, 2.0),
        ("shiftblend3d", (1, 32, 48, (5, 16, 8), 3, 1, 1, 1, 2, 4), True, True, 1.5, 1.5),
        ("shiftblend3d", (1, 16, 24, (5, 8, 16), 5, 1, 2, 1, 1, 1), True, True, 1.3, 1.0),
        ("gathermm3d", (2, 16, 24, (5, 7, 6), 3, 1, 1, 1, 2, 2), True, True, 3.0, None),
        ("gathermm3d", (1, 12, 8, (7, 9, 8), 3, 2, 1, 1, 1, 3), False, False, 2.0, None),
        ("gathermm3d", (2, 16, 16, (5, 6, 7), 3, 1, 1, 1, 1, 2), True, True, 40.0, None),
        ("gathermm3d", (2, 32, 32, (6, 6, 6), 3, 2, 1, 1, 1, 1), True, True, 0.0, None),
        ("gathermm3d", (1, 12, 10, (4, 5, 6), (3, 1, 3), 1, (1, 0, 1), 1, 2, 3), True, False,
         2.5, None),
        ("gathermm3d", (1, 16, 16, (6, 9, 10), 5, 1, 2, 1, 1, 1), True, True, 2.0, None),
        ("gathermm3d", (2, 40, 24, (5, 7, 6), 3, 1, 1, 1, 2, 4), True, True, 2.5, None),
    ]
    cases = []
    for fam, (b, c, o, S, k, s, p, d, g, dg), modulated, with_bias, scale, bound in table:
        spec = DeformConvSpec.make(3, k, s, p, d, g, dg, modulated=modulated)
        OS, K = spec.out_sizes(S), spec.tap_count
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        x = t(rng.standard_normal((b, c) + S))
        off = t(rng.uniform(-scale, scale, (b, dg * 3 * K) + OS))
        mask = t(rng.uniform(0, 1, (b, dg * K) + OS)) if modulated else None
        wt = t(rng.standard_normal((o, c // g) + spec.kernel) * 0.1)
        bias = t(rng.standard_normal((o,))) if with_bias else None
        gout = t(rng.standard_normal((b, o) + OS))
        cases.append((fam, spec, (x, off, mask, wt, bias), gout, bound))
    return cases


def work(ins, out_numel, spec):
    """(bytes, operations) of one forward and one backward: each input read
    once and each output written once (the backward reads the inputs and
    gout and writes a gradient of each input), and the products, 2 B P O
    C/g K each (the backward has two)."""
    x, off, mask, w, bias = ins
    in_bytes = sum(t.numel() * t.element_size() for t in (x, off, mask, w) if t is not None)
    ops = 2 * out_numel * (x.shape[1] // spec.groups) * spec.tap_count
    out_bytes = x.element_size() * out_numel
    return {"fwd": (in_bytes + out_bytes + (0 if bias is None else
                                            bias.element_size() * bias.numel()), ops),
            "bwd": (2 * in_bytes + out_bytes, 2 * ops)}


def bound_of(n_bytes, n_ops, op_type=MAIN_PRECISION):
    """The least time on the card (ms) and what sets it, at the peak rate
    of the operations' type (the main precision's for the products)."""
    return max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (n_ops / PEAK_OPS[op_type] * 1e3, "operations"))


def far(got, ref, frac=1e-3):
    """How many elements of got miss ref by more than frac of max|ref|."""
    return int(((got - ref).abs() > frac * ref.abs().max()).sum())


def on_bound(torch, off, spec, bound, origin=None):
    """How many fp32 sampling positions floor to exactly anchor + bound, where
    the bounded contract's derivative is one-sided (stride 1).  `origin`:
    the whole output's index of off's first row per dim (a shard's)."""
    nd, S = spec.ndim, off.shape[2:]
    origin = origin or (0,) * nd
    taps = torch.cartesian_prod(*[torch.arange(k) for k in spec.kernel])  # (K, nd)
    off = off.reshape(off.shape[0], -1, spec.tap_count, nd, *S)
    n = 0
    for a in range(nd):
        shape = [1] * (3 + nd)
        shape[3 + a] = S[a]
        coord = (torch.arange(S[a], device=off.device) + origin[a]).reshape(shape)
        tap = (taps[:, a] * spec.dilation[a] - spec.padding[a]).to(off.device)
        base = (coord + tap.reshape([1, 1, -1] + [1] * nd)).float()
        n += int(((torch.floor(base + off[:, :, :, a]) - base) == bound).sum())
    return n


def plain_grads_by_sample(torch, ins, spec, pair, *extra):
    """Gradients of sum(out^2) in x, offset, mask (when given) and weight by
    a kernel pair's plain versions, unchunked, one sample at a time so that
    they fit the card: grad_x, grad_offset and grad_mask belong to one
    sample each, grad_weight is the sum of the samples' parts."""
    fwd_ref, bwd_ref = pair[1], pair[3]
    x, off, mask, w, _ = ins
    parts = []
    for b in range(x.shape[0]):
        one = tuple(None if t is None else t[b:b + 1] for t in (x, off, mask))
        out = fwd_ref(*one, w, None, spec, MAIN_PRECISION, *extra)
        parts.append(bwd_ref(*one, w, 2 * out, spec, MAIN_PRECISION, *extra))
        del out
    grads = [None if parts[0][i] is None else torch.cat([p[i] for p in parts])
             for i in range(3)]
    grads.append(sum(p[3] for p in parts))
    return tuple(g for g in grads if g is not None)


def run_3d(torch, mdt, families3d, reset, counts, dev):
    """Phases 9-12: BASELINE configs 3 and 4 through the public 3D ops
    (forward and training step, launch counters, agreement with
    impl='torch', bitwise-equal repeated backwards), both 3D kernel pairs
    against their plain versions in every mode at both configs and on small
    cases, and the times.  Returns the table rows of the 3D kernels (each
    pair's at its own config), the training-step times and both pairs'
    kernel times at both configs."""
    rows, steps, cross, main = {}, {}, {}, {}
    for name, c in CFG3D.items():
        spec, ins = cfg3d_inputs(torch, dev, name)
        # `fam`: the pair whose table rows this config gives; `auto_fam`:
        # the pair "auto" takes here, as the card's profile decides.
        fam = c["family"]
        B, O = ins[0].shape[0], ins[3].shape[0]
        auto_fam = auto_pair(ins[0], spec, O, BOUND3D)
        OS = spec.out_sizes(ins[0].shape[2:])
        zero = {n: 0 for n in counts()}
        # Phase 9: the forward and the training step through the public op.
        with torch.no_grad():
            reset()
            out = op3d(mdt, name, ins, impl="auto", offset_bound=BOUND3D)
            torch.cuda.synchronize()
            fwd_launches = counts()
            check(fwd_launches == {**zero, f"{auto_fam}_fwd": 1},
                  f"{name} forward did not run through {auto_fam}_fwd alone: {fwd_launches}")
            torch.cuda.reset_peak_memory_stats()
            ref = op3d(mdt, name, ins, impl="torch")
            e = rel_err(out, ref)
            print(f"{name} forward path launches {fwd_launches}; vs impl='torch' rel err {e:.3e} "
                  f"(plain path peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
            check(out.shape == (B, O) + OS and bool(torch.isfinite(out).all()),
                  f"{name} output {tuple(out.shape)} bad")
            check(e <= LIMITS[MAIN_PRECISION], f"{name} forward disagrees: {e:.3e}")
            del out, ref
        pb = PLAIN_BATCH[name]
        leaves = [t.detach().clone().requires_grad_(True) for t in ins if t is not None]
        names = [n for n, t in zip(("x", "offset", "mask", "weight"), ins) if t is not None]

        def step(**kw):
            out = op3d(mdt, name, refill(ins, leaves), **kw)
            return torch.autograd.grad((out * out).sum(), leaves)

        reset()
        grads = step(impl="auto", offset_bound=BOUND3D)
        torch.cuda.synchronize()
        step_launches = counts()
        check(step_launches == {**zero, f"{auto_fam}_fwd": 1, f"{auto_fam}_bwd": 1},
              f"{name} training step did not run through the {auto_fam} pair alone: "
              f"{step_launches}")
        main[name] = {n: fwd_launches[n] + step_launches[n] for n in zero}
        if auto_fam.startswith("gathermm3d"):
            g_ref, against = step(impl="torch"), "impl='torch'"
        else:
            # The bounded pair is held against its own plain version, which
            # keeps the bounded contract's window: where an fp32 position
            # lands exactly on anchor + bound (7 samples in config 4's
            # inputs) the window makes the offset derivative one-sided, and
            # impl='torch' (no window) takes the other side.  Sample by
            # sample, because the plain version holds a sample's columns at
            # once.
            g_ref = plain_grads_by_sample(torch, ins, spec, families3d[auto_fam], BOUND3D)
            against = "its plain version"
            g_path = step(impl="torch")
            print(f"{name} training step vs impl='torch': " + " ".join(
                f"{n} {rel_err(g, r):.3e} ({far(g, r)} elements off by > 1e-3 of max)"
                for n, g, r in zip(names, grads, g_path))
                + f"; offsets equal to the bound: {int((ins[1] == BOUND3D).sum())}, "
                f"positions on anchor + bound: {on_bound(torch, ins[1], spec, BOUND3D)}")
            del g_path
        errs = {n: rel_err(g, r) for n, g, r in zip(names, grads, g_ref)}
        print(f"{name} training step launches {step_launches}; vs {against}: "
              + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))
        for (n, e), g in zip(errs.items(), grads):
            check(bool(torch.isfinite(g).all()), f"{name} grad_{n} not finite")
            check(e <= LIMITS[MAIN_PRECISION], f"{name} training step grad_{n} disagrees: {e:.3e}")
        again = step(impl="auto", offset_bound=BOUND3D)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"{name} training step: two backward runs differ")
        print(f"{name} training step: two backward runs bitwise equal")
        del grads, again, g_ref
        it_k, it_p = TIMING3D[name]["kernel"], TIMING3D[name]["plain"]
        steps[name] = {"auto": time_ms(lambda: step(impl="auto", offset_bound=BOUND3D), *it_k),
                       "plain": time_ms(lambda: step(impl="torch"), *it_p)}
        print(f"{name} training step (fwd + bwd of sum(out^2), {len(leaves)} grads): "
              f"{steps[name]['auto']:.4f} ms through {auto_fam} (previous release "
              f"{PREV_STEP_MS[name + ' step']} ms), {steps[name]['plain']:.4f} ms plain")
        del leaves

        with torch.no_grad():
            # Phase 10: both 3D pairs against their plain versions, every
            # mode, at the config (config 4 at B=1).
            cut = tuple(None if t is None or i > 2 else t[:pb].contiguous()
                        for i, t in enumerate(ins))[:3] + ins[3:]
            gout = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (B, O) + OS).astype(np.float32)).to(dev)
            torch.cuda.reset_peak_memory_stats()
            for f, (fwd, fwd_ref, bwd, bwd_ref) in families3d.items():
                rel = {}
                for prec, limit in LIMITS.items():
                    args = (*cut, spec, prec, BOUND3D)[:7 if f == "gathermm3d" else 8]
                    got, want = fwd(*args), fwd_ref(*args)
                    rel[prec] = {"out": rel_err(got, want)}
                    if f == fam and prec == MAIN_PRECISION:
                        rows[f"{f}_fwd"] = {"max_abs_err": float((got - want).abs().max())}
                    del got, want
                    bargs = (*cut[:4], gout[:pb], *args[5:])
                    got, want = bwd(*bargs), bwd_ref(*bargs)
                    rel[prec].update(grad_rel_errs(got, want))
                    if f == fam and prec == MAIN_PRECISION:
                        rows[f"{f}_bwd"] = {"max_abs_err": max_abs(got, want)}
                    del got, want
                    for n, e in rel[prec].items():
                        if e is not None:
                            check(e <= limit, f"{f} {name} B={pb} {prec} {n}: rel err {e:.3e}")
                    print(f"{f} {name} B={pb} {prec}: " + " ".join(
                        f"{n} {e:.3e}" for n, e in rel[prec].items() if e is not None)
                        + f" (limit {limit:g})")
                if f == fam:
                    for kind in ("fwd", "bwd"):
                        rows[f"{f}_{kind}"]["rel_err"] = {
                            p: {n: e for n, e in r.items() if (n == "out") == (kind == "fwd")}
                            for p, r in rel.items()}
            print(f"{name} B={pb}: plain versions' peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

            # Phase 11: times in the main path's mode.  Both pairs at the
            # config's own batch (cross), the config's own pair and its
            # plain versions at the plain batch (the table row), and cuDNN's
            # dense conv3d at both batches as the anchor.
            cross[name] = {}
            for f, (fwd, fwd_ref, bwd, bwd_ref) in families3d.items():
                args = (*ins, spec, MAIN_PRECISION, BOUND3D)[:7 if f == "gathermm3d" else 8]
                bargs = (*ins[:4], gout, *args[5:])
                cross[name][f"{f}_fwd"] = time_ms(lambda: fwd(*args), *it_k)
                cross[name][f"{f}_bwd"] = time_ms(lambda: bwd(*bargs), *it_k)
                print_breakdown(f"{f}_fwd {name} B={B} profile",
                                device_time_by_kernel(lambda: fwd(*args), calls=2))
                print_breakdown(f"{f}_bwd {name} B={B} profile",
                                device_time_by_kernel(lambda: bwd(*bargs), calls=2))
            anchors3d = {}
            for nb in sorted({pb, B}):
                xa, wa, ga = ins[0][:nb], ins[3], gout[:nb]
                anchors3d[nb] = {
                    "fwd": time_ms(lambda: torch.nn.functional.conv3d(xa, wa, None, 1, 1), *it_k),
                    "bwd": time_ms(lambda: torch.ops.aten.convolution_backward(
                        ga, xa, wa, None, [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1,
                        [True, True, False]), *it_k)}
            print(f"{name} both pairs at B={B}: " + " ".join(
                f"{n} {ms:.4f} ms" for n, ms in cross[name].items())
                + f"; dense conv3d anchors {anchors3d}")
            pair_ms = {f: cross[name][f"{f}_fwd"] + cross[name][f"{f}_bwd"] for f in families3d}
            print(f"{name} (profile sb_wide_bound_3d {current_profile_of(ins[0]).sb_wide_bound_3d}, "
                  f"bound {BOUND3D}): 'auto' takes {auto_fam}; fwd + bwd " + ", ".join(
                      f"{f} {ms:.4f} ms" for f, ms in pair_ms.items())
                  + (f"; the faster / the taken one "
                     f"{min(pair_ms.values()) / pair_ms[auto_fam]:.3f}x" if auto_fam in pair_ms
                     else ""))
            fwd, fwd_ref, bwd, bwd_ref = families3d[fam]
            args = (*cut, spec, MAIN_PRECISION, BOUND3D)[:7 if fam == "gathermm3d" else 8]
            bargs = (*cut[:4], gout[:pb], *args[5:])
            own = {"fwd": (fwd, fwd_ref, args), "bwd": (bwd, bwd_ref, bargs)}
            w_pb, w_full = work(cut, pb * O * math.prod(OS), spec), work(ins, gout.numel(), spec)
            for kind, (fn, ref_fn, a) in own.items():
                n = f"{fam}_{kind}"
                ms = (cross[name][n] if pb == B else time_ms(lambda: fn(*a), *it_k))
                if pb != B:
                    print_breakdown(f"{n} {name} B={pb} profile",
                                    device_time_by_kernel(lambda: fn(*a), calls=2))
                plain_ms = time_ms(lambda: ref_fn(*a), *it_p)
                bound_ms, bound_by = bound_of(*w_pb[kind])
                rows[n].update(
                    config_launches=(fwd_launches if kind == "fwd" else step_launches)[n], ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    at=f"{name} B={pb}")
                rows[n][f"dense_conv_{kind}_anchor_ms"] = anchors3d[pb][kind]
                if pb != B:
                    rows[n].update({f"ms_{name}_B{B}": cross[name][n],
                                    f"bound_ms_{name}_B{B}": bound_of(*w_full[kind])[0],
                                    f"dense_conv_{kind}_anchor_ms_{name}_B{B}":
                                        anchors3d[B][kind]})
                print(f"{n} {name} B={pb}: {ms:.4f} ms (plain {plain_ms:.3f} ms, dense conv3d "
                      f"{kind} anchor {anchors3d[pb][kind]:.4f} ms, bound {bound_ms:.4f} ms by "
                      f"{bound_by}; work {w_pb[kind][0] / 1e6:.1f} MB, "
                      f"{w_pb[kind][1] / 1e9:.2f} GFLOP)")
            del gout, cut
        del ins
        torch.cuda.empty_cache()

    # Phase 12: both 3D pairs on the small cases, every mode.
    with torch.no_grad():
        for fam, sspec, args, sgout, bound in small_cases3(torch, dev):
            fwd, fwd_ref, bwd, bwd_ref = families3d[fam]
            ext = () if bound is None else (bound,)
            xs, offs, masks, ws, _ = args
            for prec, limit in LIMITS.items():
                e = rel_err(fwd(*args, sspec, prec, *ext), fwd_ref(*args, sspec, prec, *ext))
                check(e <= limit, f"{fam}_fwd small case {sspec} {prec}: rel err {e:.3e}")
                bargs = (xs, offs, masks, ws, sgout, sspec, prec, *ext)
                got, want = bwd(*bargs), bwd_ref(*bargs)
                for n, e in grad_rel_errs(got, want).items():
                    if e is not None:
                        check(e <= limit, f"{fam}_bwd small case {sspec} {prec} grad_{n}: "
                              f"rel err {e:.3e}")
                again = bwd(*bargs)
                check(all(torch.equal(a, b) for a, b in zip(got, again) if a is not None),
                      f"{fam}_bwd small case {sspec}: two runs differ")
            print(f"{fam} small case S={tuple(xs.shape[2:])} k={sspec.kernel} s={sspec.stride} "
                  f"d={sspec.dilation} g={sspec.groups} dg={sspec.deformable_groups} "
                  f"bound={bound} max|off|={float(offs.abs().max()):.2f} mask={masks is not None}: "
                  "fwd + bwd ok, backward bitwise repeatable")
    return {"rows": rows, "steps": steps, "cross": cross, "main_launches": main}


def cfg5_inputs(torch, dev, layer, seed=0):
    """A config-5 layer's inputs (x, offset, mask, weight, bias) as
    benchmarks/suite.py builds them, from a numpy seed."""
    C, S = CFG5[layer]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = (rng.standard_normal((CFG5_B, C, S, S), dtype=f32),
            rng.uniform(-2, 2, (CFG5_B, 18, S, S)).astype(f32),
            rng.uniform(0, 1, (CFG5_B, 9, S, S)).astype(f32),
            rng.standard_normal((C, C, 3, 3), dtype=f32) * f32(0.05),
            np.zeros((C,), f32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrs)


def cols3d_inputs(torch, dev, seed=0):
    """The 3D columns case's spec and inputs (x, offset, mask, weight,
    bias), from a numpy seed."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    c = COLS3D
    B, C, S, g, K = c["B"], c["C"], c["S"], c["groups"], 27
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = (rng.standard_normal((B, C) + S, dtype=f32),
            rng.uniform(-2, 2, (B, 3 * K) + S).astype(f32),
            rng.uniform(0, 1, (B, K) + S).astype(f32),
            rng.standard_normal((C, C // g, 3, 3, 3), dtype=f32) * f32(0.05),
            rng.standard_normal((C,), dtype=f32) * f32(0.1))
    spec = DeformConvSpec.make(3, 3, 1, 1, 1, g, 1, modulated=True)
    return spec, tuple(torch.from_numpy(a).to(dev) for a in arrs)


def small_cases_cols(torch, dev):
    """Small configs for the column kernels: conv groups straddling one
    deformable group (g > dg), g = dg where the fused backward's footprint
    keeps the JAX package off its fused pair, masked and unmasked, stride
    2, offsets far outside the input, ragged tiles, a 2D plane of several
    input tiles of the column backward, 2D and 3D; each with a cotangent of
    the op's output."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    rng = np.random.default_rng(4)
    # (B, C, O, S, k, stride, pad, dil, g, dg), modulated, bias, offset scale
    table = [
        ((2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 1), True, True, 3.0),
        ((1, 12, 8, (11, 13), 3, 2, 1, 1, 1, 3), False, False, 8.0),
        ((2, 32, 32, (7, 7), 3, 1, 1, 1, 4, 2), True, True, 40.0),
        ((1, 1024, 1536, (5, 6), 3, 1, 1, 1, 1, 1), True, True, 2.0),
        ((1, 12, 16, (40, 36), 3, 1, 1, 1, 2, 1), True, True, 3.0),
        ((2, 16, 24, (5, 7, 6), 3, 1, 1, 1, 2, 1), True, True, 3.0),
        ((1, 12, 8, (7, 9, 8), 3, 2, 1, 1, 1, 3), False, False, 2.0),
        ((2, 16, 16, (5, 6, 7), 3, 1, 1, 1, 4, 2), True, False, 40.0),
    ]
    cases = []
    for (b, c, o, S, k, s, p, d, g, dg), modulated, with_bias, scale in table:
        spec = DeformConvSpec.make(len(S), k, s, p, d, g, dg, modulated=modulated)
        OS, K = spec.out_sizes(S), spec.tap_count
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        ins = (t(rng.standard_normal((b, c) + S)),
               t(rng.uniform(-scale, scale, (b, dg * len(S) * K) + OS)),
               t(rng.uniform(0, 1, (b, dg * K) + OS)) if modulated else None,
               t(rng.standard_normal((o, c // g) + spec.kernel) * 0.05),
               t(rng.standard_normal((o,))) if with_bias else None)
        cases.append((spec, ins, t(rng.standard_normal((b, o) + OS))))
    return cases


def grid_sample_columns(torch, x, off, mask, spec):
    """The columns by one `grid_sample` call over every tap at once
    (bilinear / trilinear, zeros padding, align_corners=True), times the
    mask: the library yardstick of the column kernels (dg = 1; the
    sampling grid is set-up, not timed).  Returns fn(x, grid, mask) and
    those three inputs; fn's output is (B, C, K * OS[0], *OS[1:])."""
    from modulated_deform_conv_tpu_torch.ops import core
    nd, K, B = spec.ndim, spec.tap_count, x.shape[0]
    S, OS = tuple(x.shape[2:]), spec.out_sizes(x.shape[2:])
    base = core._base_positions(spec, OS, x.device)                    # (nd, K, P)
    pos = base[None] + off.reshape(B, K, nd, -1).transpose(1, 2)      # (B, nd, K, P)
    norm = torch.stack([2 * pos[:, d] / (S[d] - 1) - 1 for d in reversed(range(nd))], -1)
    grid = norm.reshape((B, K * OS[0]) + OS[1:] + (nd,)).contiguous()
    m = mask.reshape((B, 1, K * OS[0]) + OS[1:])

    def fn(x, grid, m):
        return torch.nn.functional.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                               align_corners=True) * m
    return fn, (x, grid, m)


def cols_work(ins, cols_numel, elem_bytes):
    """(bytes, FP32 operations) of the column kernels: x, offset and mask
    read once and the columns written (forward); the cotangent read and
    grad_x, grad_offset and grad_mask written besides (backward).  Each
    column value blends 4 (2D) or 8 (3D) corners, and the backward does it
    twice (the pull and the correlation)."""
    x, off, mask = ins[:3]
    in_bytes = sum(t.numel() * t.element_size() for t in (x, off, mask) if t is not None)
    corners = 2 ** (x.dim() - 2)
    return {"fwd": (in_bytes + elem_bytes * cols_numel, 2 * corners * cols_numel),
            "bwd": (2 * in_bytes + elem_bytes * cols_numel, 4 * corners * cols_numel)}


def cols_fwd_routes(torch, gm, label, spec, ins, key):
    """The column forward's two routes (gathermm.cols_fwd_plan) on one
    case in every mode: the same bits from both (checked), and the SHA-256
    of the columns beside the previous release's (PREV_COLS_FWD_DIGESTS,
    printed).  Returns the route the plan picks and {mode: digest equal}."""
    import hashlib
    x, off, mask = ins[:3]
    name = "gathermm_cols_fwd" if spec.ndim == 2 else "gathermm3d_cols_fwd"
    route = gm.cols_fwd_plan(spec, x.shape[2:], spec.out_sizes(x.shape[2:]), x.shape[0],
                             x.shape[1]).route
    same_as_prev = {}
    for prec in LIMITS:
        got = {r: gm.cols_fwd(x, off, mask, spec, prec, route=r) for r in ("plane", "gather")}
        check(torch.equal(got["plane"], got["gather"]), f"{label} {name} {prec}: the routes differ")
        digest = hashlib.sha256(got[route].view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        same_as_prev[prec] = digest == PREV_COLS_FWD_DIGESTS[key][
            "bfloat16" if prec == "bfloat16" else "float32"]
        del got
    print(f"{label} {name}: route {route}; plane and gather routes bitwise equal in every mode; "
          f"the previous release's bits: " + " ".join(f"{p} {v}" for p, v in same_as_prev.items()))
    return route, same_as_prev


def prev_ms(prev, name):
    """The previous release's time of a kernel, printed."""
    return f"{prev[name]:.4f} ms" if name in prev else "not timed"


def columns_case(torch, gm, label, spec, ins, op, reset, counts, pair, fused_pair, dense,
                 prev=PREV_MS, key=None):
    """One config through the public op and the columns path: the counted
    forward and training step (grads of sum(out^2) in all five inputs),
    agreement with impl='torch' and with the fused pair on the same inputs,
    bitwise-equal repeated backwards, each column kernel against its plain
    version in every mode, the column forward's routes (cols_fwd_routes;
    `key` names the case's PREV_COLS_FWD_DIGESTS), and the times (main
    precision), each column kernel's beside `prev` (the previous release's)
    and split by kernel, the forward's gather route beside its plane route.
    Returns the launches, the kernel rows and the times."""
    from modulated_deform_conv_tpu_torch.ops.cuda import lib
    zero = {n: 0 for n in counts()}
    fwd, bwd = pair
    fwd_ref, bwd_ref = gm.gathermm_cols_reference, gm.gathermm_cols_bwd_reference
    names5 = ("x", "offset", "mask", "weight", "bias")
    x, off, mask, w, b = ins
    B, O = x.shape[0], w.shape[0]
    OS = spec.out_sizes(x.shape[2:])
    P, K = math.prod(OS), spec.tap_count
    fam = entry_of(fwd, spec.ndim)[:-4]
    with torch.no_grad():
        reset()
        out = op(ins, impl="auto")
        torch.cuda.synchronize()
        fwd_launches = counts()
    check(fwd_launches == {**zero, f"{fam}_fwd": 1},
          f"{label} forward did not run through {fam}_fwd alone: {fwd_launches}")
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]

    def step(**kw):
        y = op(leaves, **kw)
        return torch.autograd.grad((y * y).sum(), leaves)

    reset()
    grads = step(impl="auto")
    torch.cuda.synchronize()
    step_launches = counts()
    check(step_launches == {**zero, f"{fam}_fwd": 1, f"{fam}_bwd": 1},
          f"{label} training step did not run through the {fam} pair alone: {step_launches}")
    with torch.no_grad():
        ref = op(ins, impl="torch")
    check(out.shape == (B, O) + OS and bool(torch.isfinite(out).all()), f"{label} output bad")
    e_out = rel_err(out, ref)
    check(e_out <= LIMITS[MAIN_PRECISION], f"{label} forward vs impl='torch': {e_out:.3e}")
    g_ref = step(impl="torch")
    errs = {n: rel_err(g, r) for n, g, r in zip(names5, grads, g_ref)}
    for n, e in errs.items():
        check(bool(torch.isfinite(grads[names5.index(n)]).all()), f"{label} grad_{n} not finite")
        check(e <= LIMITS[MAIN_PRECISION], f"{label} training step grad_{n} vs impl='torch': {e:.3e}")
    again = step(impl="auto")
    check(all(torch.equal(a, c) for a, c in zip(grads, again)), f"{label}: two backward runs differ")
    # The same function through the fused pair, called directly.
    fl = [t.detach().clone().requires_grad_(True) for t in ins]
    y = gm._GathermmFwd.apply(*fl, spec, MAIN_PRECISION)
    g_fused = torch.autograd.grad((y * y).sum(), fl)
    e_fused = {"out": rel_err(out, y.detach())}
    e_fused.update({n: rel_err(g, r) for n, g, r in zip(names5, grads, g_fused)})
    for n, e in e_fused.items():
        check(e <= LIMITS[MAIN_PRECISION], f"{label} columns path vs fused pair, {n}: {e:.3e}")
    print(f"{label}: forward launches {launched(fwd_launches)}, step launches "
          f"{launched(step_launches)}; vs "
          f"impl='torch' out {e_out:.3e} " + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + "; vs the fused pair " + " ".join(f"{n} {e:.3e}" for n, e in e_fused.items())
          + "; two backward runs bitwise equal")
    del out, ref, grads, again, g_ref, y, g_fused, fl

    rows = {f"{fam}_fwd": {"rel_err": {}}, f"{fam}_bwd": {"rel_err": {}}}
    gen = torch.Generator(device=x.device).manual_seed(2)
    with torch.no_grad():
        for prec, limit in LIMITS.items():
            got, want = fwd(x, off, mask, spec, prec), fwd_ref(x, off, mask, spec, prec)
            check(got.dtype == want.dtype and got.shape == (x.shape[1] * K, B * P),
                  f"{label} {fam}_fwd {prec}: {got.dtype} {tuple(got.shape)}")
            e = rel_err(got, want)
            rows[f"{fam}_fwd"]["rel_err"][prec] = e
            if prec == MAIN_PRECISION:
                rows[f"{fam}_fwd"]["max_abs_err"] = float((got.float() - want.float()).abs().max())
            gcols = torch.randn(got.shape, generator=gen, device=x.device).to(got.dtype)
            del got, want
            g_got = bwd(x, off, mask, gcols, spec, prec)
            g_want = bwd_ref(x, off, mask, gcols, spec, prec)
            errs = {n: rel_err(a, r) for n, a, r in zip(names5, g_got, g_want) if r is not None}
            rows[f"{fam}_bwd"]["rel_err"][prec] = errs
            if prec == MAIN_PRECISION:
                rows[f"{fam}_bwd"]["max_abs_err"] = max_abs(g_got, g_want)
            check(e <= limit and all(v <= limit for v in errs.values()),
                  f"{label} column kernels vs plain, {prec}: out {e:.3e} {errs}")
            print(f"{fam} {label} {prec}: cols {e:.3e} " + " ".join(
                f"grad_{n} {v:.3e}" for n, v in errs.items()) + f" (limit {limit:g})")
            del g_got, g_want, gcols

        route, same_as_prev = cols_fwd_routes(torch, gm, label, spec, ins, key)
        rows[f"{fam}_fwd"].update(cols_route=route, same_bits_as_previous_release=same_as_prev)

        # Times, in the main path's mode.
        t = {}
        cols = fwd(x, off, mask, spec, MAIN_PRECISION)
        gcols = torch.randn(cols.shape, generator=gen, device=x.device).to(cols.dtype)
        gout = torch.randn((B, O) + OS, generator=gen, device=x.device)
        g, Og = spec.groups, O // spec.groups
        wg = w.reshape(g, Og, -1).to(cols.dtype)
        cg = cols.view(g, wg.shape[2], -1)
        go = gout.transpose(0, 1).reshape(g, Og, -1).to(cols.dtype).contiguous()
        t["cols_fwd"] = time_ms(lambda: fwd(x, off, mask, spec, MAIN_PRECISION))
        t["cols_fwd_gather_route"] = time_ms(lambda: gm.cols_fwd(
            x, off, mask, spec, MAIN_PRECISION, route="gather"))
        split = kernel_split(device_time_by_kernel(lambda: fwd(x, off, mask, spec, MAIN_PRECISION)))
        rows[f"{fam}_fwd"].update(split_ms=split, device_ms=sum(split.values()) if split else None,
                                  gather_route_ms=t["cols_fwd_gather_route"])
        print(f"{label} {fam}_fwd: {t['cols_fwd']:.4f} ms on events, {route} route (previous release "
              f"{prev_ms(prev, f'{fam}_fwd')}; gather route {t['cols_fwd_gather_route']:.4f} ms), "
              + (f"{sum(split.values()):.4f} ms device: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()) if split else "device time not measured"))
        t["cols_bwd"] = time_ms(lambda: bwd(x, off, mask, gcols, spec, MAIN_PRECISION))
        split = kernel_split(device_time_by_kernel(
            lambda: bwd(x, off, mask, gcols, spec, MAIN_PRECISION)))
        rows[f"{fam}_bwd"].update(split_ms=split, device_ms=sum(split.values()) if split else None)
        print(f"{label} {fam}_bwd: {t['cols_bwd']:.4f} ms on events (previous release "
              f"{prev_ms(prev, f'{fam}_bwd')}), "
              + (f"{sum(split.values()):.4f} ms device: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()) if split else "device time not measured"))
        t["cols_fwd_plain"] = time_ms(lambda: fwd_ref(x, off, mask, spec, MAIN_PRECISION),
                                      *TIMING_PLAIN5)
        t["cols_bwd_plain"] = time_ms(lambda: bwd_ref(x, off, mask, gcols, spec, MAIN_PRECISION),
                                      *TIMING_PLAIN5)
        with gm._matmul_mode(MAIN_PRECISION):
            t["gemm_fwd"] = time_ms(lambda: gm._bmm(wg, cg))
            t["gemm_bwd"] = time_ms(lambda: (gm._bmm(wg.transpose(1, 2), go, cols.dtype),
                                             gm._bmm(go, cg.transpose(1, 2))))
        t["op_fwd"] = time_ms(lambda: op(ins, impl="auto"))
        fargs = (x, off, mask, w, b, spec, MAIN_PRECISION)
        t["fused_fwd"] = time_ms(lambda: fused_pair[0](*fargs))
        t["fused_bwd"] = time_ms(lambda: fused_pair[1](x, off, mask, w, gout, spec, MAIN_PRECISION))
        t["dense_fwd"], t["dense_bwd"] = dense(x, w, gout)
        gfn, gins = grid_sample_columns(torch, x, off, mask, spec)
        ys = gfn(*gins)
        e_gs = rel_err(ys.reshape(B, x.shape[1], K, P).permute(1, 2, 0, 3).reshape(cols.shape),
                       fwd_ref(x, off, mask, spec, "float32"))
        check(e_gs <= 1e-3, f"{label}: grid_sample computes other columns ({e_gs:.3e})")
        t["grid_sample_fwd"] = time_ms(lambda: gfn(*gins))
    with torch.enable_grad():
        gl = [u.detach().clone().requires_grad_(True) for u in gins]
        yl = gfn(*gl)
        gy = torch.randn(yl.shape, generator=gen, device=x.device)
        t["grid_sample_bwd"] = time_ms(lambda: torch.autograd.grad(yl, gl, gy, retain_graph=True))
        del yl, gl
    t["step"] = time_ms(lambda: step(impl="auto"))
    t["step_plain"] = time_ms(lambda: step(impl="torch"), *TIMING_PLAIN5)
    print_breakdown(f"{label} training step profile",
                    device_time_by_kernel(lambda: step(impl="auto")), top=10)
    gemm_ops = 2 * B * P * O * (x.shape[1] // g) * K
    work = cols_work(ins, cols.numel(), cols.element_size())
    for kind in ("fwd", "bwd"):
        bound_ms, bound_by = bound_of(*work[kind], "float32")
        rows[f"{fam}_{kind}"].update(
            config_launches=(fwd_launches if kind == "fwd" else step_launches)[f"{fam}_{kind}"],
            ms=t[f"cols_{kind}"], plain_ms=t[f"cols_{kind}_plain"], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=t[f"grid_sample_{kind}"], at=label,
            library="torch.nn.functional.grid_sample (+ mask), one call over all taps",
            gemm_ms=t[f"gemm_{kind}"], fused_pair_ms=t[f"fused_{kind}"],
            dense_conv_anchor_ms=t[f"dense_{kind}"])
    t["gemm_tflops_fwd"] = gemm_ops / t["gemm_fwd"] / 1e9
    t["gemm_tflops_bwd"] = 2 * gemm_ops / t["gemm_bwd"] / 1e9
    print(f"{label} times (ms, {MAIN_PRECISION}): " + " ".join(
        f"{n} {v:.4f}" for n, v in t.items()) + f"; GEMM {gemm_ops / 1e9:.1f} GFLOP fwd; column "
        f"bounds fwd {rows[f'{fam}_fwd']['bound_ms']:.4f} / bwd {rows[f'{fam}_bwd']['bound_ms']:.4f}"
        f" ms; grid_sample vs the columns {e_gs:.2e}")
    del cols, gcols, gout, go, gins, leaves
    torch.cuda.empty_cache()
    return {"fwd": fwd_launches, "step": step_launches}, rows, t


def cols_fwd_c3(torch, gm, label, spec, ins):
    """The column forward called directly at config 5's c3 shape (which
    the copied `_fuse_ok` keeps on the fused pair): its routes and bits
    (cols_fwd_routes), its agreement with the plain version, and its time
    beside its bound and `grid_sample`'s."""
    x, off, mask = ins[:3]
    cols_fwd_routes(torch, gm, label, spec, ins, "c3")
    with torch.no_grad():
        cols = gm.cols_fwd(x, off, mask, spec, MAIN_PRECISION)
        e = rel_err(cols, gm.gathermm_cols_reference(x, off, mask, spec, MAIN_PRECISION))
        check(e <= LIMITS[MAIN_PRECISION], f"{label} gathermm_cols_fwd vs plain: {e:.3e}")
        t = {"cols_fwd": time_ms(lambda: gm.cols_fwd(x, off, mask, spec, MAIN_PRECISION)),
             "cols_fwd_gather_route": time_ms(lambda: gm.cols_fwd(
                 x, off, mask, spec, MAIN_PRECISION, route="gather"))}
        t["cols_fwd_bound"], by = bound_of(*cols_work(ins, cols.numel(), cols.element_size())["fwd"],
                                           "float32")
        gfn, gins = grid_sample_columns(torch, x, off, mask, spec)
        t["cols_fwd_grid_sample"] = time_ms(lambda: gfn(*gins))
        split = kernel_split(device_time_by_kernel(
            lambda: gm.cols_fwd(x, off, mask, spec, MAIN_PRECISION)))
    print(f"{label} gathermm_cols_fwd, called directly: {t['cols_fwd']:.4f} ms on events (gather route "
          f"{t['cols_fwd_gather_route']:.4f} ms), bound {t['cols_fwd_bound']:.4f} ms ({by}), grid_sample "
          f"{t['cols_fwd_grid_sample']:.4f} ms; vs plain {e:.3e}; "
          + (", ".join(f"{k} {v:.4f}" for k, v in split.items()) if split else "device time not measured"))
    del cols, gins
    return t


def run_columns(torch, mdt, gm, reset, counts, dev):
    """Phases 14-16: the unfused columns path.  BASELINE config 5's sweep
    through the public op (each layer on the pair the card's profile takes:
    the JAX package's rule keeps c3 on the fused pair, the H100's sends it
    to the column kernels as c4 and c5), the 3D columns case and its Pack
    module, and small cases of the column kernels and of the op."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    from modulated_deform_conv_tpu_torch.utils.device import reference_profile
    F = torch.nn.functional
    res = {"rows": {}, "times": {}, "launches": {}}
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    zero = {n: 0 for n in counts()}

    def op5(ins, **kw):
        return mdt.modulated_deform_conv2d(*ins, 1, 1, 1, 1, 1, **kw)

    def dense2(x, w, gout):
        return (time_ms(lambda: F.conv2d(x, w, None, 1, 1)),
                time_ms(lambda: torch.ops.aten.convolution_backward(
                    gout, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                    [True, True, False])))

    # Phase 14: the config-5 sweep: forward, then training step, each layer
    # counted; the counts are set to 0 before each run of the sweep.
    sweep = {"fwd": dict(zero), "step": dict(zero)}
    for layer, (C, S) in CFG5.items():
        ins = cfg5_inputs(torch, dev, layer)
        label = f"cfg5 {layer} ({C} ch, {S}x{S}, B={CFG5_B})"
        pair = auto_pair(ins[0], spec, C)
        print(f"{label}: 'auto' takes {pair} (JAX's `_fuse_ok`: "
              f"{gm.jax_fuse_ok(ins[0], spec, C, None, reference_profile())})")
        if pair == "gathermm":
            with torch.no_grad():
                reset()
                out = op5(ins, impl="auto")
                torch.cuda.synchronize()
                fl = counts()
                ref = op5(ins, impl="torch")
            check(fl == {**zero, "gathermm_fwd": 1}, f"{label} forward took {fl}")
            e = rel_err(out, ref)
            check(e <= LIMITS[MAIN_PRECISION] and bool(torch.isfinite(out).all()),
                  f"{label} forward vs impl='torch': {e:.3e}")
            del out, ref
            leaves = [t.clone().requires_grad_(True) for t in ins]

            def step(**kw):
                y = op5(leaves, **kw)
                return torch.autograd.grad((y * y).sum(), leaves)

            reset()
            grads = step(impl="auto")
            torch.cuda.synchronize()
            sl = counts()
            check(sl == {**zero, "gathermm_fwd": 1, "gathermm_bwd": 1}, f"{label} step took {sl}")
            errs = [rel_err(g, r) for g, r in zip(grads, step(impl="torch"))]
            check(max(errs) <= LIMITS[MAIN_PRECISION], f"{label} step vs impl='torch': {errs}")
            again = step(impl="auto")
            check(all(torch.equal(a, c) for a, c in zip(grads, again)),
                  f"{label}: two backward runs differ")
            del grads, again

            def cols_step():
                y = gm.deform_conv_cols(*leaves, spec, MAIN_PRECISION)
                return torch.autograd.grad((y * y).sum(), leaves)

            with torch.no_grad():
                t = {"op_fwd": time_ms(lambda: op5(ins, impl="auto")),
                     "gathermm_fwd": time_ms(lambda: gm.fused_fwd(*ins, spec, MAIN_PRECISION)),
                     "columns_path_op_fwd": time_ms(
                         lambda: gm.deform_conv_cols(*ins, spec, MAIN_PRECISION))}
            t["gathermm_fwd_bound"], bound_by = bound_of(
                *work(ins, CFG5_B * C * S * S, spec)["fwd"])
            t.update(cols_fwd_c3(torch, gm, label, spec, ins))
            print(f"{label}: gathermm_fwd {t['gathermm_fwd']:.4f} ms, bound "
                  f"{t['gathermm_fwd_bound']:.4f} ms ({bound_by}); op forward {t['op_fwd']:.4f} ms "
                  f"(previous release {PREV_STEP_MS['cfg5 c3 op_fwd']} ms)")
            # The same layer forced onto the columns path, for comparison.
            t.update(step=time_ms(lambda: step(impl="auto")),
                     columns_path_step=time_ms(cols_step),
                     step_plain=time_ms(lambda: step(impl="torch"), *TIMING_PLAIN5))
            print(f"{label}: forward launches {launched(fl)}, step launches {launched(sl)}; "
                  f"vs impl='torch' out "
                  f"{e:.3e}, grads worst {max(errs):.3e}; two backward runs bitwise equal; "
                  + " ".join(f"{n} {v:.4f} ms" for n, v in t.items()))
            del leaves
        else:
            launches, res["rows"][layer], t = columns_case(
                torch, gm, label, spec, ins, op5, reset, counts,
                (gm.cols_fwd, gm.cols_bwd), (gm.fused_fwd, gm.fused_bwd),
                dense2, {"c3": PREV_MS_C3, "c5": PREV_MS_C5}.get(layer, PREV_MS), key=layer)
            fl, sl = launches["fwd"], launches["step"]
            if layer == "c3":
                # The fused forward at c3 beside its bound, as the fused
                # branch records it.
                t["gathermm_fwd"] = t["fused_fwd"]
                t["gathermm_fwd_bound"] = bound_of(*work(ins, CFG5_B * C * S * S, spec)["fwd"])[0]
        res["times"][f"cfg5_{layer}"] = t
        for kind, c in (("fwd", fl), ("step", sl)):
            sweep[kind] = {n: sweep[kind][n] + v for n, v in c.items()}
        del ins
        torch.cuda.empty_cache()
    res["launches"]["cfg5"] = sweep
    print(f"cfg5 sweep launches: forward {launched(sweep['fwd'])}; training step "
          f"{launched(sweep['step'])}")

    # Phase 15: the 3D columns path at config 3's size with groups=2, and
    # ModulatedDeformConv3dPack(groups=2).
    spec3, ins3 = cols3d_inputs(torch, dev)
    g3 = spec3.groups

    def op3(ins, **kw):
        return mdt.modulated_deform_conv3d(*ins, 1, 1, 1, g3, 1, **kw)

    def dense3(x, w, gout):
        return (time_ms(lambda: F.conv3d(x, w, None, 1, 1, 1, g3)),
                time_ms(lambda: torch.ops.aten.convolution_backward(
                    gout, x, w, None, [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, g3,
                    [True, True, False])))

    c = COLS3D
    label3 = f"3D columns (B={c['B']}, {c['C']} ch, {c['S']}, g={g3}, dg=1)"
    launches3, rows3, t3 = columns_case(
        torch, gm, label3, spec3, ins3, op3, reset, counts,
        (gm.cols_fwd, gm.cols_bwd),
        (gm.fused_fwd, gm.fused_bwd), dense3, key="3d")
    res["rows"]["3d"], res["times"]["cols3d"] = rows3, t3
    res["launches"]["cols3d"] = launches3
    x3 = ins3[0]
    torch.manual_seed(0)
    mod = mdt.ModulatedDeformConv3dPack(c["C"], c["C"], 3, padding=1, groups=g3, device=dev)
    with torch.no_grad():
        reset()
        y = mod(x3)
        torch.cuda.synchronize()
        pl = counts()
        check(pl == {**zero, "gathermm3d_cols_fwd": 1}, f"ModulatedDeformConv3dPack(groups=2) took {pl}")
        want = mdt.modulated_deform_conv3d(x3, mod.conv_offset(x3), mod.conv_mask(x3), mod.weight,
                                           mod.bias, 1, 1, 1, g3, 1, impl="torch")
        e = rel_err(y, want)
        check(e <= LIMITS[MAIN_PRECISION], f"ModulatedDeformConv3dPack(groups=2) vs plain: {e:.3e}")
    print(f"ModulatedDeformConv3dPack(groups={g3}): launches {launched(pl)}, vs impl='torch' "
          f"rel err {e:.3e}")
    del mod, y, want, ins3
    torch.cuda.empty_cache()

    # Phase 16: small cases, every mode: the column kernels against their
    # plain versions (and bitwise-repeated backwards), and where the card's
    # fuse rule (`plan.fuse_ok`) is false the op through "auto" (counted)
    # against impl='torch'.
    gen = torch.Generator(device=dev).manual_seed(5)
    for sspec, ins, gout in small_cases_cols(torch, dev):
        x, off, mask, w, b = ins
        fwd, bwd = gm.cols_fwd, gm.cols_bwd
        with torch.no_grad():
            for prec, limit in LIMITS.items():
                got = fwd(x, off, mask, sspec, prec)
                e = rel_err(got, gm.gathermm_cols_reference(x, off, mask, sspec, prec))
                gcols = torch.randn(got.shape, generator=gen, device=dev).to(got.dtype)
                g_got = bwd(x, off, mask, gcols, sspec, prec)
                g_want = gm.gathermm_cols_bwd_reference(x, off, mask, gcols, sspec, prec)
                errs = [rel_err(a, r) for a, r in zip(g_got, g_want) if r is not None]
                check(e <= limit and max(errs) <= limit,
                      f"column kernels small case {sspec} {prec}: {e:.3e} {errs}")
                check(all(torch.equal(a, r) for a, r in zip(
                    g_got, bwd(x, off, mask, gcols, sspec, prec)) if a is not None),
                    f"column backward small case {sspec}: two runs differ")
        fused = gm.fuse_ok(x, sspec, w.shape[0])
        msg = "fused pair under auto"
        if not fused:
            fn = mdt.modulated_deform_conv2d if sspec.ndim == 2 else mdt.modulated_deform_conv3d
            if mask is None:
                fn = mdt.deform_conv2d if sspec.ndim == 2 else mdt.deform_conv3d
            leaves = [None if u is None else u.clone().requires_grad_(True) for u in ins]
            live = [u for u in leaves if u is not None]

            def run(impl):
                args = [u for u in leaves[:3] if u is not None] + leaves[3:]
                y = fn(*args, sspec.stride, sspec.padding, sspec.dilation, sspec.groups,
                       sspec.deformable_groups, impl=impl)
                return [y.detach()] + list(torch.autograd.grad(y, live, gout))

            reset()
            got = run("auto")
            torch.cuda.synchronize()
            cl = counts()
            d = "" if sspec.ndim == 2 else "3d"
            check(cl == {**zero, f"gathermm{d}_cols_fwd": 1, f"gathermm{d}_cols_bwd": 1},
                  f"small case {sspec} under auto took {cl}")
            errs = [rel_err(a, r) for a, r in zip(got, run("torch"))]
            check(max(errs) <= LIMITS[MAIN_PRECISION], f"small case {sspec} op vs impl='torch': {errs}")
            msg = f"columns path under auto, op + grads vs impl='torch' worst {max(errs):.2e}"
        print(f"column kernels small case S={tuple(x.shape[2:])} C={x.shape[1]} O={w.shape[0]} "
              f"s={sspec.stride} g={sspec.groups} dg={sspec.deformable_groups} "
              f"max|off|={float(off.abs().max()):.1f} mask={mask is not None}: kernels ok in every "
              f"mode, backward bitwise repeatable; {msg}")
    return res


def unsharded_digests(torch, gm, sb, dev):
    """{kernel: {mode: SHA-256 of its outputs}} for every kernel, unsharded,
    at its table row's config: the 2D pairs at config 2, gathermm3d at
    config 3, shiftblend3d at config 4 with B=1, the 2D column pair at
    config 5 c4 and the 3D one at the 3D columns case; each backward with a
    cotangent from a seeded generator."""
    import hashlib
    from modulated_deform_conv_tpu_torch.ops.cuda.lib import PRECISIONS
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

    def digest(ts):
        h = hashlib.sha256()
        for t in ts if isinstance(ts, tuple) else (ts,):
            if t is not None:
                h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    def cot(shape, dtype=torch.float32):
        g = torch.Generator(device=dev).manual_seed(1)
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    spec2 = DeformConvSpec.make(2, KS, 1, 1, 1, G, DG, modulated=True)
    ins2 = cfg2_inputs(torch, dev)
    spec3, ins3 = cfg3d_inputs(torch, dev, "cfg3")
    spec4, ins4 = cfg3d_inputs(torch, dev, "cfg4")
    ins4 = tuple(None if t is None else t[:1].contiguous() for t in ins4)
    fused = [("shiftblend", sb.fwd, sb.bwd, spec2, ins2, (BOUND,)),
             ("gathermm", gm.fused_fwd, gm.fused_bwd, spec2, ins2, ()),
             ("gathermm3d", gm.fused_fwd, gm.fused_bwd, spec3, ins3, ()),
             ("shiftblend3d", sb.fwd, sb.bwd, spec4, ins4, (BOUND3D,))]
    spec5 = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    spec_c3, ins_c3 = cols3d_inputs(torch, dev)
    cols = [("gathermm_cols", spec5, cfg5_inputs(torch, dev, "c4")),
            ("gathermm3d_cols", spec_c3, ins_c3)]
    out = {}
    for prec in PRECISIONS:
        for fam, fwd, bwd, spec, (x, off, mask, w, b), ext in fused:
            y = fwd(x, off, mask, w, b, spec, prec, *ext)
            out.setdefault(f"{fam}_fwd", {})[prec] = digest(y)
            out.setdefault(f"{fam}_bwd", {})[prec] = digest(
                bwd(x, off, mask, w, cot(y.shape), spec, prec, *ext))
            del y
        for fam, spec, (x, off, mask, _, _) in cols:
            c = gm.cols_fwd(x, off, mask, spec, prec)
            out.setdefault(f"{fam}_fwd", {})[prec] = digest(c)
            out.setdefault(f"{fam}_bwd", {})[prec] = digest(
                gm.cols_bwd(x, off, mask, cot(c.shape, c.dtype), spec, prec))
            del c
    torch.cuda.synchronize()
    return out


def sharded_case(torch, dev, which):
    """A sharded case's spec, global inputs (x, offset, mask or None,
    weight, bias or None) and its public op."""
    import modulated_deform_conv_tpu_torch as mdt
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    if which == "cfg2":
        spec = DeformConvSpec.make(2, KS, 1, 1, 1, G, DG, modulated=True)
        ins = cfg2_inputs(torch, dev)
    elif which == "c4":
        spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
        ins = cfg5_inputs(torch, dev, "c4")
    elif which in ("cfg3", "cfg4"):
        # The config's batch cut to its plain versions' (x, offset and
        # mask; the weight keeps its output channels).
        spec, ins = cfg3d_inputs(torch, dev, which)
        ins = tuple(t if t is None or i > 2 else t[:PLAIN_BATCH[which]].contiguous()
                    for i, t in enumerate(ins))
    else:
        spec, ins = cols3d_inputs(torch, dev)
    name = ("modulated_" if spec.modulated else "") + f"deform_conv{spec.ndim}d"

    def op(x, off, mask, w, b, **kw):
        args = (x, off) + ((mask,) if spec.modulated else ()) + (w, b)
        return getattr(mdt, name)(*args, spec.stride, spec.padding, spec.dilation,
                                  spec.groups, spec.deformable_groups, spec.in_step, **kw)
    return spec, list(ins), op


def add_block(gx, gxb, shards, coords):
    """The halo exchange's backward, on one device: each row of a block's
    gradient added onto the global row it holds (rows past the image
    dropped)."""
    src, dst = gxb, gx
    for s, i in zip(shards, coords):
        axis, lo = 2 + s.dim, i * s.in_local - s.halo
        a, b = max(lo, 0), min(lo + gxb.shape[axis], gx.shape[axis])
        src, dst = src.narrow(axis, a - lo, b - a), dst.narrow(axis, a, b - a)
    dst.add_(src)


def lead_kernel_checks(torch, sb, label, spec, leaves, shards, coords, sh):
    """One lead-mode shard's kernels against their plain versions on the
    card, forward and backward, in every mode at LIMITS, on the shard's
    block arguments (`sharding.block_args`) and a seeded cotangent (the 2D
    forward on both its routes, the halo tile and channels-last x); the
    worst relative error per mode and the main mode's max |d|."""
    xb, off_l, mask_l, w, b = (None if t is None else t.detach() for t in leaves)
    local, placement, gates = sh.block_args(spec, shards, coords, tuple(xb.shape[2:]))
    OS = tuple(off_l.shape[2:])
    fam = "shiftblend" if spec.ndim == 2 else "shiftblend3d"
    fwd, bwd = sb.fwd, sb.bwd
    fwd_ref, bwd_ref = sb.shiftblend_fwd_reference, sb.shiftblend_bwd_reference
    blk = (OS, gates, placement)
    g = torch.Generator(device=xb.device).manual_seed(3)
    cot = torch.randn((xb.shape[0], w.shape[0]) + OS, generator=g, device=xb.device)
    worst, max_abs_err = {}, {}
    for prec, limit in LIMITS.items():
        args = (xb, off_l, mask_l, w, b, local, prec, SHARD_MAX_OFFSET)
        got, want = fwd(*args, *blk), fwd_ref(*args, *blk)
        errs = {"out": rel_err(got, want)}
        abs_errs = [float((got - want).abs().max())]
        if spec.ndim == 2:
            for route in (True, False):
                got = sb.fwd(*args, *blk, halo=route)
                errs["out " + ("halo" if route else "xt") + " route"] = rel_err(got, want)
        del got, want
        bargs = (xb, off_l, mask_l, w, cot, local, prec, SHARD_MAX_OFFSET)
        got = bwd(*bargs, (True,) * 4, *blk)
        want = bwd_ref(*bargs, *blk)
        errs.update({f"grad_{n}": e for n, e in grad_rel_errs(got, want).items()
                     if e is not None})
        abs_errs.append(max_abs(got, want))
        del got, want
        for what, e in errs.items():
            check(e <= limit, f"{label} shard {coords} {fam} {what} {prec}: "
                  f"kernel vs plain rel err {e:.3e} (limit {limit:g})")
        worst[prec] = max(errs.values())
        max_abs_err[prec] = max(abs_errs)
    return worst, max_abs_err


def timer_ms(torch, prof, dev, fn, label):
    """Median of LEAD_TIMING samples of fn()'s time, each a Timer (CUDA
    events on the card) around LEAD_TIMING[1] calls inside an annotated
    range, after one warm-up call."""
    samples, per = LEAD_TIMING
    fn()
    times = []
    for _ in range(samples):
        with prof.annotate(label), prof.Timer(dev, name=label) as t:
            for _ in range(per):
                fn()
        times.append(t.elapsed_ms / per)
    return statistics.median(times)


def run_sharded(torch, sh, sb, reset, counts, dev):
    """The sharded phase.  Per case and shard: the exchanged block cut from
    the global tensors (zero rows past the image), `sharding.shard_conv`
    forward and backward of sum(out^2) on CUDA tensors (on LEAD_LAYOUTS
    twice: impl="shiftblend", shift-blend's lead mode, and impl="cuda", the
    gather kernels' block mode, the fused pair or the column kernels as the
    card's fuse rule decides, with the global border's gates on the edge
    shards; then "auto" once more on every shard, which must take the pass
    the card's profile names; elsewhere "auto", the gather kernels' block
    mode); (a) the lead mode's kernels against their plain versions on
    the shard's block arguments in every mode, or a gather pass's step
    against shard_conv at impl="torch", and for the lead mode a second
    step's gradients bit for bit; (b) the outputs stitched and the block
    gradients summed back as the exchange's backward does, against the
    unsharded kernel op on the global tensors (the shift-blend op at
    offset_bound 2 for the lead mode, else impl="cuda"), in the main mode
    and "float32"; (c) the kernels each shard launched (a lead-mode or
    impl="cuda" pass on a lead layout must launch the shift-blend or the
    gather pair of its rank once each and nothing else, another layout's
    shard a gather kernel); (d) one interior shard's step time beside the
    unsharded step's, and on LEAD_LAYOUTS beside the same shard on the
    gather kernels with gates (impl="cuda"), on `profiling.Timer`, and its
    device time by kernel from a `profiling.trace`.  Where the column
    forward runs, its time on the block placed in the whole input beside
    its time in the JAX package's form, the shift folded into the offsets.
    Returns {row: {case: launches and times}} and, per layout, the
    kernels "auto" launched over its shards."""
    import itertools
    import tempfile
    from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
    from modulated_deform_conv_tpu_torch.utils import profiling as prof
    from modulated_deform_conv_tpu_torch.ops.cuda import plan as plan_mod
    rows = {n: {} for n in GATHER_ROWS + LEAD_ROWS}
    main_auto = {}
    t_phase = time.time()
    for label, (which, split) in SHARDED.items():
        lead = label in LEAD_LAYOUTS
        spec, ins, op = sharded_case(torch, dev, which)
        x, off, mask, w, b = ins
        nd = spec.ndim
        names, sizes = [None] * nd, {}
        for d, n in split.items():
            names[d], sizes[f"s{d}"] = f"s{d}", n
        plan = sh.shard_plan(x.shape, off.shape, w.shape, None if mask is None else mask.shape,
                             None if b is None else b.shape, spec, sizes, None, names,
                             SHARD_MAX_OFFSET)
        lay = {2 + s.dim: s.axis_name for s in plan.shards}
        axes = [s.axis_name for s in plan.shards]
        grid = list(itertools.product(*[range(s.n_shards) for s in plan.shards]))
        fams = ("shiftblend", "gathermm") if nd == 2 else ("shiftblend3d", "gathermm3d")
        # A lead layout runs twice: forced shift-blend takes the lead mode,
        # "cuda" the gather kernels' block mode (the fused pair or the
        # column kernels, as the card's fuse rule decides on the block) on
        # the same shards; "auto" takes one of the two, as the card's
        # profile decides (sb_lead_crossover_cg), checked on one shard.

        def block(coords, **kw):
            """The shard's leaves (block, offset, mask, weight, bias)."""
            sl = sh.shard_slices(off.shape, lay, dict(zip(axes, coords)), sizes)
            return [None if t is None else t.detach().clone().requires_grad_(True)
                    for t in (sh.cut_block(x, plan.shards, coords), off[sl],
                              None if mask is None else mask[sl], w, b)], sl

        def step(leaves, coords, impl, prec):
            y = sh.shard_conv(*leaves, spec, plan.shards, coords, SHARD_MAX_OFFSET, impl, prec)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad((y * y).sum(), live))
            return y.detach(), [None if t is None else next(grads) for t in leaves]

        passes = {"auto": None}
        if lead:
            # The gather kernels' block mode takes the fused pair or the
            # column kernels as the card's fuse rule decides on the block.
            b0, sl0 = block(grid[0])
            local0 = sh.block_args(spec, plan.shards, grid[0], tuple(b0[0].shape[2:]))[0]
            gfam = fams[1] + ("" if plan_mod.fuse_ok(b0[0], local0, w.shape[0],
                                                     tuple(off[sl0].shape[2:])) else "_cols")
            passes = {"shiftblend": tuple(fams[0] + k for k in ("_fwd", "_bwd")),
                      "cuda": tuple(gfam + k for k in ("_fwd", "_bwd"))}
            del b0

        launched, kernel_err = {}, {}
        for (impl, want_rows), prec in itertools.product(passes.items(),
                                                         (MAIN_PRECISION, "float32")):
            on_lead = impl == "shiftblend"
            row_label = label if impl in ("auto", "shiftblend") else f"{label} impl={impl}"
            out = torch.empty((x.shape[0], w.shape[0]) + tuple(off.shape[2:]), device=dev)
            g_sum = [torch.zeros_like(t) if t is not None else None for t in ins]
            for coords in grid:
                leaves, sl = block(coords)
                reset()
                y, g = step(leaves, coords, impl, prec)
                torch.cuda.synchronize()
                if prec == MAIN_PRECISION:
                    c = {n: v for n, v in counts().items() if v}
                    launched.setdefault(impl, {})[coords] = c
                    if want_rows:
                        check(c == {n: 1 for n in want_rows}, f"{label} shard {coords} "
                              f"impl={impl}: launched {c}, want {want_rows} once each")
                    else:
                        check(any(c.get(n) for n in GATHER_ROWS),
                              f"{label} shard {coords}: no gather kernel launched ({c})")
                    for n, v in c.items():
                        if n in rows:
                            rows[n].setdefault(row_label, {"launches": 0})["launches"] += v
                    if on_lead:
                        # (a) the lead mode's kernels against their plain
                        # versions, every mode, and the backward's bits.
                        worst, abs_err = lead_kernel_checks(torch, sb, label, spec, leaves,
                                                            plan.shards, coords, sh)
                        for p_, e in worst.items():
                            kernel_err[p_] = max(kernel_err.get(p_, 0.0), e)
                        kernel_err["max_abs_err"] = max(kernel_err.get("max_abs_err", 0.0),
                                                        abs_err[MAIN_PRECISION])
                        _, g2 = step(block(coords)[0], coords, impl, prec)
                        check(all(a is None or torch.equal(a, b_) for a, b_ in zip(g, g2)),
                              f"{label} shard {coords}: two lead-mode backward runs differ")
                        del g2
                    else:
                        # (a) the kernels against the same function's plain path.
                        yt, gt = step(block(coords)[0], coords, "torch", prec)
                        for what, got, want in zip(("out", "x", "offset", "mask", "weight", "bias"),
                                                   [y] + g, [yt] + gt):
                            if got is not None:
                                e = rel_err(got, want)
                                check(e <= LIMITS[prec], f"{label} shard {coords} impl={impl} "
                                      f"{what}: kernels vs impl='torch' rel err {e:.3e}")
                                kernel_err[impl] = max(kernel_err.get(impl, 0.0), e)
                        del yt, gt
                out[sh.shard_slices(out.shape, lay, dict(zip(axes, coords)), sizes)] = y
                add_block(g_sum[0], g[0], plan.shards, coords)
                for k in (1, 2):
                    if g[k] is not None:
                        g_sum[k][sl] = g[k]
                for k in (3, 4):
                    if g[k] is not None:
                        g_sum[k] += g[k]
                del leaves, y, g
            # (b) stitched against the unsharded kernel op.
            leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in ins]
            kw = (dict(impl="shiftblend", offset_bound=SHARD_MAX_OFFSET) if on_lead
                  else dict(impl="cuda"))
            y0 = op(*leaves, precision=prec, **kw)
            live = [t for t in leaves if t is not None]
            g0 = iter(torch.autograd.grad((y0 * y0).sum(), live))
            errs = {"out": rel_err(out, y0.detach())}
            for what, got, t in zip(("x", "offset", "mask", "weight", "bias"), g_sum, leaves):
                if t is not None:
                    errs[what] = rel_err(got, next(g0))
            print(f"sharded {row_label} {prec}: stitched vs unsharded {kw['impl']} op rel err "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            for what, e in errs.items():
                check(e <= LIMITS[prec], f"{row_label} {prec} stitched {what} vs unsharded: "
                      f"{e:.3e}")
            del out, g_sum, leaves, y0, live
        auto_launched = {}
        if lead:
            print(f"sharded {label} impl=cuda: {'/'.join(passes['cuda'])} in block mode on every "
                  f"shard vs impl='torch', worst rel err {kernel_err['cuda']:.2e} (main mode and "
                  "float32)")
            # "auto" on every shard: the pair of the pass the profile names.
            takes_lead = sh._lead_mode(x.narrow(2, 0, plan.shards[0].in_local), spec,
                                       plan.shards, SHARD_MAX_OFFSET, "auto")
            want_rows = passes["shiftblend" if takes_lead else "cuda"]
            for coords in grid:
                reset()
                step(block(coords)[0], coords, "auto", MAIN_PRECISION)
                torch.cuda.synchronize()
                c = launched_now = {n: v for n, v in counts().items() if v}
                check(c == {n: 1 for n in want_rows}, f"{label} shard {coords} impl=auto: "
                      f"launched {launched_now}, want {want_rows} once each (the profile's "
                      f"sb_lead_crossover_cg {current_profile_of(x).sb_lead_crossover_cg}, C/dg "
                      f"{x.shape[1] // spec.deformable_groups})")
                for n, v in c.items():
                    auto_launched[n] = auto_launched.get(n, 0) + v
            print(f"sharded {label}: 'auto' takes "
                  f"{'the lead mode' if takes_lead else 'the gather kernels in block mode'} on "
                  f"every shard ({'/'.join(want_rows)}; profile sb_lead_crossover_cg "
                  f"{current_profile_of(x).sb_lead_crossover_cg}, C/dg "
                  f"{x.shape[1] // spec.deformable_groups})")
        else:
            for c in launched["auto"].values():
                for n, v in c.items():
                    auto_launched[n] = auto_launched.get(n, 0) + v
        main_auto[label] = auto_launched
        launched = launched["shiftblend" if lead else "auto"]
        kernels_hit = sorted({n for c in launched.values() for n in c})
        print(f"sharded {label}: {len(grid)} shards of block "
              f"{tuple(sh.cut_block(x, plan.shards, grid[0]).shape)}, output grid "
              f"{tuple(off.shape[2:])} / {tuple(s.n_shards for s in plan.shards)}, halo "
              f"{[s.halo for s in plan.shards]}; launched per shard: "
              + "; ".join(f"{c}: " + ", ".join(f"{n} {v}" for n, v in sorted(launched[c].items()))
                          for c in grid))
        if lead:
            print(f"sharded {label}: lead-mode kernels vs plain versions on every shard, worst rel "
                  "err " + ", ".join(f"{p_} {kernel_err[p_]:.2e}" for p_ in LIMITS)
                  + "; two backward runs bitwise equal on every shard")
        # (d) one interior shard's step beside the unsharded step (main mode).
        mid = grid[len(grid) // 2]
        leaves = block(mid)[0]
        full = [None if t is None else t.detach().clone().requires_grad_(True) for t in ins]
        full_kw = (dict(impl="shiftblend", offset_bound=SHARD_MAX_OFFSET) if lead
                   else dict(impl="cuda"))

        def full_step():
            y0 = op(*full, **full_kw)
            return torch.autograd.grad((y0 * y0).sum(), [t for t in full if t is not None])
        times = {}
        if lead:
            # The same shard on the gather kernels with gates computes the
            # same function (the offsets keep within the bound), grad_x of
            # the block's rows inside the image included (the lead mode
            # drops the corners past it, the gather kernels keep them on
            # the zero rows, whose gradient the exchange drops).
            y_l, g_l = step(leaves, mid, "shiftblend", MAIN_PRECISION)
            y_g, g_g = step(leaves, mid, "cuda", MAIN_PRECISION)
            (s0,) = plan.shards
            lo = s0.halo - mid[0] * s0.in_local
            rows_in = slice(max(0, lo), min(g_l[0].shape[2], lo + s0.in_local * s0.n_shards))
            g_l[0], g_g[0] = g_l[0][:, :, rows_in], g_g[0][:, :, rows_in]
            errs = {"out": rel_err(y_g, y_l)}
            errs.update({n: rel_err(a, b_) for n, a, b_ in zip(
                ("x", "offset", "mask", "weight", "bias"), g_g, g_l) if a is not None})
            # Where an fp32 position lands exactly on anchor + bound the
            # bounded contract's offset derivative is one-sided (as at the
            # unsharded config 4): each such position may move one offset
            # gradient element, and no more may move.
            n_on = on_bound(torch, leaves[1].detach(), spec, SHARD_MAX_OFFSET,
                            (mid[0] * s0.out_local,) + (0,) * (nd - 1))
            n_far = far(g_g[1], g_l[1])
            print(f"sharded {label}: shard {mid} on the gather kernels with gates vs the lead "
                  "mode, rel err " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f"; offset gradient elements off by > 1e-3 of max {n_far}, positions on "
                  f"anchor + bound {n_on}")
            check(all(v <= LIMITS[MAIN_PRECISION] for k, v in errs.items() if k != "offset")
                  and (errs["offset"] <= LIMITS[MAIN_PRECISION] or n_far <= n_on),
                  f"{label}: gather kernels vs lead mode {errs}, {n_far} offset gradient "
                  f"elements off, {n_on} positions on the bound")
            del y_l, g_l, y_g, g_g
            # The kernels alone on the shard's block, lead mode beside the
            # gather kernels with gates, on the same inputs.
            xb, off_l, mask_l, w_l, b_l = (None if t is None else t.detach() for t in leaves)
            local, placement, gates = sh.block_args(spec, plan.shards, mid, tuple(xb.shape[2:]))
            blk = (tuple(off_l.shape[2:]), gates, placement)
            cot = torch.randn((xb.shape[0], w_l.shape[0]) + blk[0], device=dev)
            fb = (xb, off_l, mask_l, w_l, b_l, local, MAIN_PRECISION)
            bb = (xb, off_l, mask_l, w_l, cot, local, MAIN_PRECISION)
            for key, fn, args in (
                    ("lead_fwd_ms", sb.fwd, fb + (SHARD_MAX_OFFSET, *blk)),
                    ("lead_bwd_ms", sb.bwd, bb + (SHARD_MAX_OFFSET, (True,) * 4, *blk)),
                    ("gather_fwd_ms", gm.fused_fwd, fb + blk),
                    ("gather_bwd_ms", gm.fused_bwd, bb + ((True,) * 4, *blk))):
                times[key] = timer_ms(torch, prof, dev, lambda: fn(*args), f"{label} {key}")
            print(f"sharded {label}: shard {mid} kernels alone (Timer): lead mode forward "
                  f"{times['lead_fwd_ms']:.4f} / backward {times['lead_bwd_ms']:.4f} ms, gather "
                  f"kernels with gates {times['gather_fwd_ms']:.4f} / {times['gather_bwd_ms']:.4f} ms")
            del xb, off_l, mask_l, w_l, b_l, cot
            times["shard_step_ms"] = timer_ms(torch, prof, dev, lambda: step(
                leaves, mid, "shiftblend", MAIN_PRECISION), f"{label} lead shard step")
            times["gather_shard_step_ms"] = timer_ms(torch, prof, dev, lambda: step(
                leaves, mid, "cuda", MAIN_PRECISION), f"{label} gather shard step")
            times["unsharded_step_ms"] = timer_ms(torch, prof, dev, full_step,
                                                  f"{label} unsharded shift-blend step")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
                with prof.trace(logdir) as tr:
                    with prof.annotate(f"{label} lead shard step"):
                        step(leaves, mid, "shiftblend", MAIN_PRECISION)
                trace_kb = os.path.getsize(tr.path) / 1e3
            by_kernel = {}
            from torch.autograd import DeviceType
            for e in tr.key_averages():
                if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                        and not e.is_user_annotation):
                    by_kernel[e.key] = e.self_device_time_total / 1e3
            times["shard_step_device_ms"] = sum(by_kernel.values()) if by_kernel else None
            print_breakdown(f"sharded {label} lead shard {mid} step (a {trace_kb:.0f} kB "
                            "trace)", by_kernel, top=6)
            print(f"sharded {label}: shard {mid} step on the lead mode {times['shard_step_ms']:.4f} ms, "
                  f"on the gather kernels with gates {times['gather_shard_step_ms']:.4f} ms "
                  f"({times['gather_shard_step_ms'] / times['shard_step_ms']:.3f}x), unsharded "
                  f"shift-blend step {times['unsharded_step_ms']:.4f} ms ({len(grid)} shards: "
                  f"{times['shard_step_ms'] * len(grid) / times['unsharded_step_ms']:.3f}x the "
                  "unsharded step's work on one card; Timer, CUDA events)")
        else:
            times["shard_step_ms"] = time_ms(lambda: step(leaves, mid, "auto", MAIN_PRECISION), 5, 2, 1)
            times["unsharded_step_ms"] = time_ms(full_step, 5, 2, 1)
            print(f"sharded {label}: shard {mid} step {times['shard_step_ms']:.4f} ms, unsharded "
                  f"step {times['unsharded_step_ms']:.4f} ms ({len(grid)} shards: "
                  f"{times['shard_step_ms'] * len(grid) / times['unsharded_step_ms']:.3f}x the "
                  "unsharded step's work on one card)")
        for n in kernels_hit:
            if n in rows:
                rows[n][label].update(times, shards=len(grid))
                if lead:
                    rows[n][label].update(rel_err_vs_plain={p_: kernel_err[p_] for p_ in LIMITS},
                                          max_abs_err=kernel_err["max_abs_err"])
        cols_fwd = [n for n in kernels_hit if n.endswith("cols_fwd")]
        if cols_fwd:
            # The column forward on the block in the port's form (offsets as
            # they are, the block placed in the whole input) and in the JAX
            # package's (the global-to-local shift folded into the offsets:
            # [0, 4] here, past the plane route's nominal reach of 3).
            xb, off_l, mask_l = (t.detach() for t in leaves[:3])
            local, placement, gates = sh.block_args(spec, plan.shards, mid,
                                                    tuple(xb.shape[2:]))
            delta = torch.tensor([a - o for a, o in placement], device=dev)
            folded = (off_l + delta.repeat(off_l.shape[1] // nd).reshape(
                (1, -1) + (1,) * nd)).contiguous()
            OS = tuple(off_l.shape[2:])
            fwd = gm.cols_fwd
            t_p = time_ms(lambda: fwd(xb, off_l, mask_l, local, MAIN_PRECISION, OS, gates,
                                      placement))
            t_f = time_ms(lambda: fwd(xb, folded, mask_l, local, MAIN_PRECISION, OS, gates))
            print(f"sharded {label}: {cols_fwd[0]} on the block, placed {t_p:.4f} ms, "
                  f"offsets folded (+{[v for v in delta.tolist() if v]}) {t_f:.4f} ms")
            rows[cols_fwd[0]][label].update(cols_fwd_placed_ms=t_p, cols_fwd_folded_ms=t_f)
        del leaves, full, ins, x, off, mask, w, b
        torch.cuda.empty_cache()
    print(f"sharded phase: {time.time() - t_phase:.1f} s")
    return {n: r for n, r in rows.items() if r}, main_auto


# bf16 phase: the twelve kernels on bf16 activations as they are.  Slack of
# a bf16 result over the mode's limit against its plain version: the two
# round independently to bf16, so they lie up to one ulp apart, 2^-8 to
# 2^-7 of an element at the scale (a weight gradient at config 4 B=1 in
# "float32" was 4.000e-3 of the scale off: one ulp).
BF16_SLACK = 2.0 ** -7
# The case each kernel table row's bf16 time is taken at.
BF16_ROW_CASES = {
    "shiftblend_fwd": "cfg2 bounded", "shiftblend_bwd": "cfg2 bounded",
    "gathermm_fwd": "cfg2 general", "gathermm_bwd": "cfg2 general",
    "gathermm3d_fwd": "cfg3", "gathermm3d_bwd": "cfg3",
    "shiftblend3d_fwd": "cfg4 B=1", "shiftblend3d_bwd": "cfg4 B=1",
    "gathermm_cols_fwd": "cfg5 c4", "gathermm_cols_bwd": "cfg5 c4",
    "gathermm3d_cols_fwd": "cols3d", "gathermm3d_cols_bwd": "cols3d",
}


def bf16_cases(torch, gm, sb, dev):
    """The bf16 phase's cases: label -> (spec, inputs, entry(ins, prec),
    kernel family, the family's wrapper arguments after the spec and mode).
    Config 2 with bench.py's bf16 inputs (all five in bf16) on both pairs;
    config 3 (bf16 activations, fp32 weight); config 4 at B=1 for the checks
    (all bf16); config 5 c4 on the columns path (bf16 activations, fp32
    weight and bias); the 3D columns case (all bf16)."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    bf = torch.bfloat16

    def cast(ins, acts_only):
        return [None if t is None else t.to(bf) if i < 3 or not acts_only else t
                for i, t in enumerate(ins)]

    spec2 = DeformConvSpec.make(2, KS, 1, 1, 1, G, DG, modulated=True)
    cfg2 = cast(cfg2_inputs(torch, dev), False)
    spec3, ins3 = cfg3d_inputs(torch, dev, "cfg3")
    spec4, ins4 = cfg3d_inputs(torch, dev, "cfg4")
    ins4 = [t if t is None or i > 2 else t[:PLAIN_BATCH["cfg4"]].contiguous()
            for i, t in enumerate(ins4)]
    spec5 = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    spec_c3, ins_c3 = cols3d_inputs(torch, dev)
    fused = lambda ins, s, p: gm.deform_conv_fused_pair(*ins, s, p)  # noqa: E731
    cols = lambda ins, s, p: gm.deform_conv_cols(*ins, s, p)  # noqa: E731
    shift = lambda b: (lambda ins, s, p: sb.deform_conv_shift(*ins, s, p, b))  # noqa: E731
    return {
        "cfg2 bounded": (spec2, cfg2, shift(BOUND), "shiftblend", (BOUND,)),
        "cfg2 general": (spec2, cfg2, fused, "gathermm", ()),
        "cfg3": (spec3, cast(ins3, True), fused, "gathermm3d", ()),
        "cfg4 B=1": (spec4, cast(ins4, False), shift(BOUND3D), "shiftblend3d", (BOUND3D,)),
        "cfg5 c4": (spec5, cast(cfg5_inputs(torch, dev, "c4"), True), cols, "gathermm_cols", ()),
        "cols3d": (spec_c3, cast(ins_c3, False), cols, "gathermm3d_cols", ()),
    }


def bf16_step(torch, lib, entry, spec, ins, cot, prec, route):
    """One training step through `entry` on the native route (the tensors as
    they are) or the upcast one (lib.as_f32 copies, the output cast to x's
    type): (out, grads of the inputs that are not None)."""
    leaves = [None if t is None else t.detach().requires_grad_(True) for t in ins]
    call = leaves if route == "native" else [lib.as_f32(t) for t in leaves]
    out = entry(call, spec, prec)
    if route == "upcast":
        out = out.to(ins[0].dtype)
    live = [t for t in leaves if t is not None]
    return out.detach(), torch.autograd.grad(out, live, cot)


def activation_copies(torch, fn, shapes):
    """(aten::_to_copy, aten::copy_) events of one fn() call whose tensors
    have one of the activations' `shapes`, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
        torch.cuda.synchronize()
    n = {"aten::_to_copy": 0, "aten::copy_": 0}
    for e in p.events():
        if e.name in n and any(tuple(s) in shapes for s in e.input_shapes if s):
            n[e.name] += 1
    return n


def step_memory_ms(torch, fn):
    """(peak device memory of one fn() call above what was allocated before
    it, in MB; its time on CUDA events, ms)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    return peak, time_ms(fn, iters=5, per_sample=3, warmup=1)


def run_bf16(torch, mdt, gm, sb, sh, lib, kernels, reset, counts, dev):
    """The bf16 phase.  Per case (bf16_cases), in the three modes: (1) a
    training step through the entry on the native route against the upcast
    route, out and the gradients of x, offset, mask and weight by SHA-256,
    the bias's bit-equal or within one bf16 ulp (the count of elements that
    differ printed); the launch counters of the two routes equal; (2) the
    family's forward and backward wrappers in bf16 against their plain
    versions within LIMITS + BF16_SLACK; in the main mode (3) the activation
    copies torch.profiler records in a native step (0 on the fused and
    shift-blend paths; on the columns path the product's output cast and
    its backward, as in JAX), and (4) a native and an upcast step's peak
    memory and time, and each wrapper's bf16 time beside its fp32 time at
    the same call.  Then `ModulatedDeformConv2dPack` at config 2 on bf16
    input (fp32 parameters), the cfg2-H4 interior shard on the gather
    kernels' block mode and shift-blend's lead mode (bits against the
    upcast route), config 4 at B=4 (memory and time, both routes), and the
    host's time to issue a config-2 step both ways.  The cases call the
    entries with a fixed kernel family, so their launches are kept in the
    results ("launches"), not counted as main-path launches.  Returns the
    phase's results and the Pack's launches, the phase's one run through
    the public op under "auto".  tools/time_bf16_kernels.py times the
    kernels further (repeats, per-kernel device splits, config 5 c5)."""
    import hashlib
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    t_phase = time.time()
    bf = torch.bfloat16
    digest = lambda t: hashlib.sha256(  # noqa: E731
        t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    res = {"cases": {}, "rows": {}, "steps": {}}
    for label, (spec, ins, entry, fam, extra) in bf16_cases(torch, gm, sb, dev).items():
        OS = tuple(ins[1].shape[2:])
        g = torch.Generator(device=dev).manual_seed(7)
        cot = torch.randn((ins[0].shape[0], ins[3].shape[0]) + OS, generator=g, device=dev).to(bf)
        names = [n for n, t in zip(("x", "offset", "mask", "weight", "bias"), ins) if t is not None]
        case = res["cases"][label] = {"types": [str(t.dtype) for t in ins if t is not None]}
        for prec in LIMITS:
            # (1) bits against the upcast route, and the launches of both.
            reset()
            n_out, n_grads = bf16_step(torch, lib, entry, spec, ins, cot, prec, "native")
            torch.cuda.synchronize()
            c_native = {n: v for n, v in counts().items() if v}
            case.setdefault("launches", {})[prec] = c_native
            reset()
            u_out, u_grads = bf16_step(torch, lib, entry, spec, ins, cot, prec, "upcast")
            c_up = {n: v for n, v in counts().items() if v}
            check(c_native == c_up and c_native, f"bf16 {label} {prec}: launches {c_native}, "
                  f"upcast {c_up}")
            check(n_out.dtype == bf and all(gr.dtype == t.dtype for gr, t in zip(
                n_grads, [t for t in ins if t is not None])), f"bf16 {label} {prec}: result types")
            u_grads = [u.to(n.dtype) for u, n in zip(u_grads, n_grads)]
            same = {"out": digest(n_out) == digest(u_out)}
            for n, a, b in zip(names, n_grads, u_grads):
                if n != "bias":
                    same[n] = digest(a) == digest(b)
            bias_diff = None
            if "bias" in names:
                a, b = n_grads[-1].float(), u_grads[-1].float()
                bias_diff = int((a != b).sum())
                scale = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
                check(bool(((a - b).abs() <= 2.0 ** -7 * scale).all()),
                      f"bf16 {label} {prec}: grad_bias past one bf16 ulp of the upcast route's")
            case.setdefault("same_bits", {})[prec] = same
            case.setdefault("bias_elements_differing", {})[prec] = bias_diff
            print(f"bf16 {label} {prec}: native vs upcast SHA-256 "
                  + " ".join(f"{n} {'same' if s else 'DIFFERENT'}" for n, s in same.items())
                  + ("" if bias_diff is None else f"; grad_bias {bias_diff} elements differ")
                  + f"; launches {c_native}")
            check(all(same.values()), f"bf16 {label} {prec}: bits differ from the upcast route")
            del n_out, n_grads, u_out, u_grads
            # (2) the family's wrappers in bf16 against their plain versions.
            fwd, fwd_ref = kernels[f"{fam}_fwd"]
            bwd, bwd_ref = kernels[f"{fam}_bwd"]
            limit = LIMITS[prec] + BF16_SLACK
            with torch.no_grad():
                x, off, mask, w, b = ins
                if fam.endswith("_cols"):
                    got = fwd(x, off, mask, spec, prec)
                    errs = {"cols": rel_err(got, fwd_ref(x, off, mask, spec, prec))}
                    gc = torch.randn(tuple(got.shape), generator=g, device=dev).to(got.dtype)
                    del got
                    gg = bwd(x, off, mask, gc, spec, prec)
                    errs.update(grad_rel_errs(gg, bwd_ref(x, off, mask, gc, spec, prec)))
                    del gc, gg
                else:
                    got = fwd(x, off, mask, w, b, spec, prec, *extra)
                    errs = {"out": rel_err(got, fwd_ref(x, off, mask, w, b, spec, prec, *extra))}
                    del got
                    gg = bwd(x, off, mask, w, cot, spec, prec, *extra)
                    errs.update(grad_rel_errs(gg, bwd_ref(x, off, mask, w, cot, spec, prec, *extra)))
                    del gg
                errs = {n: e for n, e in errs.items() if e is not None}
                case.setdefault("plain_rel_err", {})[prec] = errs
                print(f"bf16 {label} {prec}: {fam} wrappers vs plain "
                      + " ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (limit {limit:.3e})")
                for n, e in errs.items():
                    check(e <= limit, f"bf16 {label} {prec}: {fam} {n} vs plain {e:.3e}")
            torch.cuda.empty_cache()
        # (3) activation copies in a native and an upcast step.
        shapes = {tuple(t.shape) for t in ins[:3] if t is not None} | {tuple(cot.shape)}
        copies = {r: activation_copies(torch, lambda: bf16_step(
            torch, lib, entry, spec, ins, cot, MAIN_PRECISION, r), shapes)
            for r in ("native", "upcast")}
        case["activation_copies"] = copies
        print(f"bf16 {label}: activation-shaped copies in one step (torch.profiler) "
              f"native {copies['native']}, upcast {copies['upcast']}")
        n_copies = sum(copies["native"].values())
        if fam.endswith("_cols"):
            # The product's fp32 output cast to x's type, and its backward.
            check(copies["native"]["aten::_to_copy"] == 2,
                  f"bf16 {label}: columns path copies {copies['native']}")
        else:
            check(n_copies == 0, f"bf16 {label}: the native step copied activations "
                  f"{copies['native']}")
        # (4) a step's memory and time both ways, in turns (native, upcast,
        # native, upcast); each wrapper in bf16 and fp32.
        for r in ("native", "upcast", "native", "upcast"):
            mb, ms = step_memory_ms(torch, lambda: bf16_step(
                torch, lib, entry, spec, ins, cot, MAIN_PRECISION, r))
            case[f"{r}_step_peak_mb"] = mb
            case.setdefault(f"{r}_step_ms", []).append(ms)
        print(f"bf16 {label} training step ({MAIN_PRECISION}): native {case['native_step_ms']} "
              f"ms, peak +{case['native_step_peak_mb']:.1f} MB; upcast {case['upcast_step_ms']} "
              f"ms, peak +{case['upcast_step_peak_mb']:.1f} MB")
        with torch.no_grad():
            x, off, mask, w, b = ins
            up = [lib.as_f32(t) for t in ins]
            cot32 = cot.float()
            for kind in ("fwd", "bwd"):
                name = f"{fam}_{kind}"
                if BF16_ROW_CASES[name] != label:
                    continue
                fn = kernels[name][0]
                if fam.endswith("_cols"):
                    cshape = (x.shape[1] * spec.tap_count, x.shape[0] * math.prod(OS))
                    gc = torch.randn(cshape, generator=g, device=dev).to(gm._cols_dtype(MAIN_PRECISION))
                    calls = ((lambda a: fn(*a[:3], spec, MAIN_PRECISION)) if kind == "fwd" else
                             (lambda a: fn(*a[:3], gc, spec, MAIN_PRECISION)))
                else:
                    calls = ((lambda a: fn(*a, spec, MAIN_PRECISION, *extra)) if kind == "fwd" else
                             (lambda a: fn(*a[:4], cot if a[0].dtype == bf else cot32, spec,
                                           MAIN_PRECISION, *extra)))
                row = {"at": label, "bf16_ms": time_ms(lambda: calls(ins)),
                       "fp32_same_call_ms": time_ms(lambda: calls(up))}
                # The bf16 call's bound: its own types' bytes, the
                # operations at the mode's peak (the column kernels' blends
                # at the FP32 rate), as the fp32 rows count them.
                if fam.endswith("_cols"):
                    wk = cols_work(ins, math.prod(cshape), gc.element_size())[kind]
                    row["bound_ms"], row["bound_by"] = bound_of(*wk, "float32")
                else:
                    wk = work(ins, cot.numel(), spec)[kind]
                    row["bound_ms"], row["bound_by"] = bound_of(*wk)
                res["rows"][name] = row
                print(f"{name} at {label} ({MAIN_PRECISION}): bf16 {row['bf16_ms']:.4f} ms, "
                      f"fp32 {row['fp32_same_call_ms']:.4f} ms; bf16 bound "
                      f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
            del up
        torch.cuda.empty_cache()

    # The Pack at config 2 on bf16 input, fp32 parameters.
    torch.manual_seed(0)
    x2 = cfg2_inputs(torch, dev)[0].to(bf)
    mod = mdt.ModulatedDeformConv2dPack(C, O, KS, padding=1, groups=G, deformable_groups=DG,
                                        bias=True, device=dev)
    reset()
    y = mod(x2)
    torch.cuda.synchronize()
    lc = {n: v for n, v in counts().items() if v}
    pack_launches = counts()
    with torch.no_grad():
        p_off = mod._predict(mod.conv_offset, x2)
        p_mask = mod._predict(mod.conv_mask, x2)
    spec2 = DeformConvSpec.make(2, KS, 1, 1, 1, G, DG, modulated=True)
    pins = [x2, p_off, p_mask, mod.weight.detach(), mod.bias.detach()]
    op2 = lambda ins, s, p: mdt.modulated_deform_conv2d(*ins, 1, 1, 1, G, DG, precision=p)  # noqa: E731
    g = torch.Generator(device=dev).manual_seed(8)
    cot = torch.randn(tuple(y.shape), generator=g, device=dev).to(bf)
    n_out, n_grads = bf16_step(torch, lib, op2, spec2, pins, cot, MAIN_PRECISION, "native")
    u_out, u_grads = bf16_step(torch, lib, op2, spec2, pins, cot, MAIN_PRECISION, "upcast")
    same = [torch.equal(y.detach(), n_out), torch.equal(n_out, u_out)] + [
        torch.equal(a, b.to(a.dtype)) for a, b in list(zip(n_grads, u_grads))[:4]]
    res["pack"] = {"launches": lc, "types": [str(t.dtype) for t in pins],
                   "grad_types": [str(t.dtype) for t in n_grads], "same_bits": same}
    print(f"bf16 Pack cfg2 (fp32 parameters): out {y.dtype}, launches {lc}, grads "
          f"{[str(t.dtype) for t in n_grads]}, bits vs upcast (module, out, x, offset, mask, "
          f"weight) {same}")
    check(y.dtype == bf and lc and all(same), "bf16 Pack at config 2")
    del mod, y, n_out, n_grads, u_out, u_grads, pins

    # The cfg2-H4 interior shard on both sharded modes.
    spec, gins, _ = sharded_case(torch, dev, "cfg2")
    gins = [t.to(bf) for t in gins]
    x, off, mask, w, b = gins
    plan = sh.shard_plan(x.shape, off.shape, w.shape, mask.shape, b.shape, spec, {"s0": 4},
                         None, ["s0", None], SHARD_MAX_OFFSET)
    coords = (1,)
    sl = sh.shard_slices(off.shape, {2: "s0"}, {"s0": 1}, {"s0": 4})
    blk = [sh.cut_block(x, plan.shards, coords), off[sl].contiguous(), mask[sl].contiguous(), w, b]
    res["sharded"] = {}
    for impl in ("cuda", "shiftblend"):
        shard = lambda ins, s, p, impl=impl: sh.shard_conv(  # noqa: E731
            *ins, s, plan.shards, coords, SHARD_MAX_OFFSET, impl, p)
        g = torch.Generator(device=dev).manual_seed(9)
        OS = tuple(blk[1].shape[2:])
        cot = torch.randn((x.shape[0], w.shape[0]) + OS, generator=g, device=dev).to(bf)
        for prec in LIMITS:
            reset()
            n_out, n_grads = bf16_step(torch, lib, shard, spec, blk, cot, prec, "native")
            c_native = {n: v for n, v in counts().items() if v}
            reset()
            u_out, u_grads = bf16_step(torch, lib, shard, spec, blk, cot, prec, "upcast")
            c_up = {n: v for n, v in counts().items() if v}
            same = [torch.equal(n_out, u_out)] + [torch.equal(a, u.to(a.dtype))
                                                  for a, u in list(zip(n_grads, u_grads))[:4]]
            a, b_ = n_grads[4].float(), u_grads[4].to(bf).float()
            bias_diff = int((a != b_).sum())
            scale = torch.maximum(a.abs(), b_.abs()).clamp_min(1e-30)
            check(bool(((a - b_).abs() <= 2.0 ** -7 * scale).all()), f"bf16 cfg2-H4 shard "
                  f"impl={impl} {prec}: grad_bias past one bf16 ulp of the upcast route's")
            res["sharded"].setdefault(impl, {})[prec] = {"same_bits": same, "launches": c_native,
                                                         "bias_elements_differing": bias_diff}
            print(f"bf16 cfg2-H4 shard 1 impl={impl} {prec}: bits vs upcast (out, x, offset, "
                  f"mask, weight) {same}; grad_bias {bias_diff} elements differ; launches "
                  f"{c_native}")
            check(all(same) and c_native == c_up and c_native,
                  f"bf16 cfg2-H4 shard impl={impl} {prec}")
    del blk, gins, x, off, mask, w, b

    # Config 4 at B=4 (memory and time only), and the host's time to issue
    # a config-2 step, both ways.
    torch.cuda.empty_cache()
    spec4, ins4 = cfg3d_inputs(torch, dev, "cfg4")
    ins4 = [None if t is None else t.to(bf) for t in ins4]
    g = torch.Generator(device=dev).manual_seed(10)
    cot4 = torch.randn((ins4[0].shape[0], ins4[3].shape[0]) + tuple(ins4[1].shape[2:]),
                       generator=g, device=dev).to(bf)
    entry4 = lambda ins, s, p: sb.deform_conv_shift(*ins, s, p, BOUND3D)  # noqa: E731
    for r in ("native", "upcast", "native", "upcast"):
        mb, ms = step_memory_ms(torch, lambda: bf16_step(
            torch, lib, entry4, spec4, ins4, cot4, MAIN_PRECISION, r))
        st = res["steps"].setdefault(f"cfg4 B=4 {r}", {"peak_mb": mb, "ms": []})
        st["ms"].append(ms)
        print(f"bf16 cfg4 B=4 training step {r}: {ms:.4f} ms, peak +{mb:.1f} MB")
    del ins4, cot4
    torch.cuda.empty_cache()
    spec2 = DeformConvSpec.make(2, KS, 1, 1, 1, G, DG, modulated=True)
    ins2 = [t.to(bf) for t in cfg2_inputs(torch, dev)]
    cot2 = torch.randn((B, O, H, W), generator=g, device=dev).to(bf)
    for label, entry in (("bounded", lambda ins, s, p: sb.deform_conv_shift(*ins, s, p, BOUND)),
                         ("general", lambda ins, s, p: gm.deform_conv_fused_pair(*ins, s, p))):
        for r in ("native", "upcast", "native", "upcast"):
            ms = host_ms(lambda: bf16_step(torch, lib, entry, spec2, ins2, cot2, MAIN_PRECISION, r))
            res["steps"].setdefault(f"cfg2 {label} host_ms", {}).setdefault(r, []).append(ms)
        h = res["steps"][f"cfg2 {label} host_ms"]
        print(f"bf16 cfg2 {label} step, host time to issue: native {h['native']} ms, upcast "
              f"{h['upcast']} ms")
    print(f"bf16 phase: {time.time() - t_phase:.1f} s")
    return res, pack_launches


def run_calibration(torch, dev):
    """calibrate --quick on the card, every time a captured chain's: the
    raw rates beside the pinned peaks, the quick points, and the profile
    they derive beside the H100 entry of the table and the profile in
    force; fails where a point moves a committed value."""
    from modulated_deform_conv_tpu_torch import calibrate
    from modulated_deform_conv_tpu_torch.utils.device import table_entry
    t0 = time.time()
    res = calibrate.calibrate(dev, quick=True, log=lambda m: print(f"  calibrate: {m}"))
    kind = res["kind"]
    m = res["measured"]
    print(f"calibrate --quick ({time.time() - t0:.1f} s, timing {json.dumps(res['timing'])}): "
          f"TF32 matmul "
          f"{m['tf32_matmul_flops'] / 1e12:.1f} TFLOP/s (pinned peak "
          f"{PEAK_OPS['tensorfloat32'] / 1e12:.0f}), bf16 {m['bf16_matmul_flops'] / 1e12:.1f} "
          f"({PEAK_OPS['bfloat16'] / 1e12:.0f}), FP32 FMA {m['fp32_fma_flops'] / 1e12:.1f} "
          f"({PEAK_OPS['float32'] / 1e12:.0f}), HBM copy {m['hbm_copy_bytes_per_s'] / 1e12:.2f} TB/s "
          f"({HBM_BYTES_PER_S / 1e12:.2f})")
    print(f"calibrate --quick on {kind}: derived {json.dumps(res['profile'])}; the table's entry "
          f"{json.dumps(table_entry(kind))}; the profile in force {json.dumps(res['base'])}")
    check(not res["contradicts"], f"calibrate --quick contradicts the committed profile at "
          f"{res['contradicts']}: {json.dumps(res['profile'])} against {json.dumps(res['base'])}")
    return {"kind": kind, "measured": m, "derived": res["profile"], "committed": res["base"],
            "timing": res["timing"], "seconds": time.time() - t0,
            "points": {rule: [{k: ({"ms": v["ms"], "spread": v["spread"]}
                                   if isinstance(v, dict) else v) for k, v in r.items()}
                              for r in rows] for rule, rows in res["timings"].items()}}


def run_smoke_example(torch, reset, counts, dev):
    """examples/smoke.py on the card: both 2D ops through the kernels
    (impl="cuda"), outputs and grad_x 9 / 6 / 4, and the pair its launches
    name."""
    from modulated_deform_conv_tpu_torch.examples import smoke
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    from modulated_deform_conv_tpu_torch.utils import graphs
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    fam = auto_pair(torch.empty((1, 1, 5, 5), device=dev), spec, 1)
    # Captured on the card: each of the two ops' steps runs the warm-up
    # calls and the capture; replays count nothing.
    n = 2 * (1 + graphs.WARMUP)
    reset()
    smoke.run(dev)
    torch.cuda.synchronize()
    c = launched(counts())
    check(c == {f"{fam}_fwd": n, f"{fam}_bwd": n},
          f"smoke example launched {c}, want {fam} {n} times each")
    print(f"smoke example on the card, captured: out and grad_x 9 / 6 / 4 for both 2D ops; "
          f"launches {c}")


def run_autotune(torch, gm, dev):
    """utils/autotune.py on the column forward at config 5 c4: every knob
    variant gives the same bits (SHA-256), then the tuned winner, each
    variant timed by the chain timer (graphs.time_chain, autotune's
    default) with its spread; the knobs are reset afterwards."""
    import hashlib
    from modulated_deform_conv_tpu_torch.utils import autotune, graphs
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    x, off, mask = cfg5_inputs(torch, dev, "c4")[:3]

    def fn():
        return gm.cols_fwd(x, off, mask, spec, MAIN_PRECISION)
    digests = {}
    with torch.no_grad():
        for v in autotune.DEFAULT_VARIANTS:
            autotune.apply(v)
            plan = gm.cols_fwd_plan(spec, x.shape[2:], x.shape[2:], x.shape[0], x.shape[1])
            digests[json.dumps(v)] = (hashlib.sha256(fn().view(torch.uint8).cpu().numpy()
                                                     .tobytes()).hexdigest(), plan.route,
                                      plan.splits)
        autotune.reset()
        check(len({d for d, _, _ in digests.values()}) == 1,
              f"autotune variants give other bits: {digests}")
        times = {}

        def timer(f):
            r = graphs.time_chain(f)
            times[json.dumps({k: v for k, v in autotune.current().items() if v})] = {
                "ms": r["ms"], "spread": r["spread"], "kernels": r["kernels"]["hi"]}
            return r["ms"]
        best = autotune.autotune(fn, "cfg5 c4 gathermm_cols_fwd", device=dev, timer=timer)
        autotune.reset()
    print("autotune cfg5 c4 gathermm_cols_fwd: every variant the same bits ("
          + "; ".join(f"{v}: route {r}, {s_} splits" for v, (_, r, s_) in digests.items())
          + f"); chained times (n_lo {graphs.N_LO}, n_hi {graphs.N_HI}) " + ", ".join(
              f"{v} {t['ms']:.4f} ms (spread {t['spread']:.3f})" for v, t in times.items())
          + f"; winner {best}")
    return {"winner": best, "ms": times}


def nccl_one_rank(torch, mdt, dev):
    """The public sharded entry on a one-rank NCCL DeviceMesh, initialised
    through a file:// store: config 2 with max_offset 2 (every axis of size
    1, so the call dispatches with offset_bound=2, the shift-blend kernel),
    against the unsharded op with offset_bound=2."""
    import tempfile
    import torch.distributed as dist
    from modulated_deform_conv_tpu_torch.parallel import (
        device_summary, initialize_distributed, make_mesh,
        sharded_modulated_deform_conv2d)
    store = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl_"), "store")
    initialize_distributed(f"file://{store}", world_size=1, rank=0, backend="nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "space"), device_type="cuda")
        x, off, mask, w, b = cfg2_inputs(torch, dev)
        with torch.no_grad():
            y = sharded_modulated_deform_conv2d(
                x, off, mask, w, b, mesh=mesh, stride=1, padding=1, groups=G,
                deformable_groups=DG, max_offset=BOUND)
            y0 = mdt.modulated_deform_conv2d(x, off, mask, w, b, 1, 1, 1, G, DG,
                                             offset_bound=BOUND)
        e = rel_err(y, y0)
        print(f"one-rank NCCL mesh ({device_summary()}): "
              f"sharded_modulated_deform_conv2d vs the op, rel err {e:.3e}")
        check(e == 0.0, f"one-rank sharded entry differs from the op: {e:.3e}")
    finally:
        dist.destroy_process_group()


# The captured-steps phase: each step captured once as a CUDA graph
# (utils/graphs.py, the port's counterpart of jax.jit) and replayed.  Op
# steps: the public op's training step (out and the gradients of
# sum(out^2)) under "auto"; network steps: the trainer's AdamW step, the
# same number of steps captured and eager.  Network relative limit where a
# library op with atomics keeps two eager runs from the same bits; it holds
# the first loss and the gradients of one step from the same parameters
# (`same_params_grad_gaps`), since AdamW turns a last-bit difference in a
# gradient near 0 into a step of lr either way.  The gradients may part by
# up to CAPTURED_NOISE times as much as two eager steps part from each
# other, where that is more (DCNResNet3d-50's max_pool3d backward parts its
# stem's gradients by 0.75-1.5e-5 captured against eager and 1.3e-5 eager
# against eager on an H100).
CAPTURED_NET_LIMIT = 1e-5
CAPTURED_NOISE = 10
# (label, size, the trainer's arch) of each network captured.
CAPTURED_NETS = (("DCNResNet-50", RESNET, "resnet"), ("DCNVideoNet", VIDEO, "video"),
                 ("DCNResNet3d-50", RESNET3D, "resnet3d"))


def captured_op_cases(torch, mdt, dev):
    """label -> (op(*leaves), the inputs of numpy seeds 0 and 1, None
    dropped): config 2 bounded and general in fp32 and bf16 (bench.py's
    inputs, all five cast), config 3 at B=2 with and without its bound,
    cfg3-D4's interior shard, config 1 and the small volume without a
    bound, config 5 c4 and the 3D columns case."""
    cases = {}
    for tname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for label, kw in (("bounded", dict(offset_bound=BOUND)), ("general", {})):
            cases[f"cfg2 {label} {tname}"] = (
                lambda *a, kw=kw: mdt.modulated_deform_conv2d(*a, 1, 1, 1, G, DG, impl="auto",
                                                              **kw),
                [[t.to(dt) for t in cfg2_inputs(torch, dev, seed)] for seed in (0, 1)])
    for label, kw in (("bounded", dict(offset_bound=BOUND3D)), ("general", {})):
        ins = [cfg3d_inputs(torch, dev, "cfg3", seed)[1] for seed in (0, 1)]
        cases[f"cfg3 B=2 {label}"] = (
            lambda *a, kw=kw, shape=ins[0]: op3d(mdt, "cfg3", refill(shape, a), impl="auto", **kw),
            [[t for t in i if t is not None] for i in ins])
    # An interior shard of cfg3-D4 through the sharding layer's per-shard
    # function under "auto": shift-blend's lead mode or the gather
    # kernels' block mode, as the card's profile decides.
    from modulated_deform_conv_tpu_torch.parallel import sharding as sh
    spec3 = cfg3d_inputs(torch, dev, "cfg3")[0]
    shards = []
    for seed in (0, 1):
        x, off, _, w, _ = cfg3d_inputs(torch, dev, "cfg3", seed)[1]
        plan = sh.shard_plan(x.shape, off.shape, w.shape, None, None, spec3, {"s0": 4}, None,
                             ["s0", None, None], SHARD_MAX_OFFSET)
        sl = sh.shard_slices(off.shape, {2: "s0"}, {"s0": 1}, {"s0": 4})
        shards.append([sh.cut_block(x, plan.shards, (1,)), off[sl].contiguous(), w])
    cases["cfg3-D4 shard 1"] = (
        lambda xb, o, w, p=plan.shards: sh.shard_conv(xb, o, None, w, None, spec3, p, (1,),
                                                      SHARD_MAX_OFFSET, "auto", MAIN_PRECISION),
        shards)
    # BASELINE config 1 without its bound and the small volume: the fused
    # gather pairs, 2D and 3D, under "auto" (PLAIN_CASES).
    for name in ("cfg1", "small volume"):
        spec_p = plain_case_inputs(torch, dev, name)[0]
        cases[f"{name} general"] = (
            lambda *a, fn=plain_case_op(mdt, spec_p): fn(*a, impl="auto"),
            [plain_case_inputs(torch, dev, name, seed)[1] for seed in (0, 1)])
    cases["cfg5 c4"] = (lambda *a: mdt.modulated_deform_conv2d(*a, 1, 1, impl="auto"),
                        [list(cfg5_inputs(torch, dev, "c4", seed)) for seed in (0, 1)])
    cases["3D columns"] = (
        lambda *a: mdt.modulated_deform_conv3d(*a, 1, 1, 1, COLS3D["groups"], 1, impl="auto"),
        [list(cols3d_inputs(torch, dev, seed)[1]) for seed in (0, 1)])
    return cases


def same_params_grad_gaps(torch, cap, ref, train_step):
    """From the eager model's parameters, each leaf's gradient gap (max
    |difference| over max |eager gradient|) of one replay of the captured
    step against one eager step, and of a second eager step against the
    first: the library's own parting from run to run.  The replay leaves
    its gradients in the parameters' `grad`."""
    start = {k: v.clone() for k, v in ref["model"].state_dict().items()}
    x, y = ref["batch"]

    def load(model):
        with torch.no_grad():
            own = model.state_dict()
            for k, v in start.items():
                own[k].copy_(v)

    eager = []
    for _ in range(2):
        load(ref["model"])
        train_step(ref["model"], ref["optimizer"], x, y)
        eager.append([p.grad.clone() for p in ref["model"].parameters()])
    load(cap["model"])
    cap["step"](x, y)
    torch.cuda.synchronize()
    names = [n for n, _ in ref["model"].named_parameters()]
    captured = {n: rel_err(p.grad, g)
                for n, p, g in zip(names, cap["model"].parameters(), eager[0])}
    again = {n: rel_err(a, b) for n, a, b in zip(names, eager[1], eager[0])}
    return captured, again


def wall_ms(fn, calls=10):
    """Median host-clock time of one fn() call ending in a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_times(fn, wall, events=(20, 10), host=(10, 5)):
    """A step's times (ms): `wall`, its host clock ending in a synchronise,
    then CUDA events over back-to-back calls, the profiler's device time
    (None where the trace holds none) and the host's time to issue one
    call."""
    prof = device_time_by_kernel(fn)
    return {"wall_ms": wall, "events_ms": time_ms(fn, *events),
            "device_ms": sum(prof.values()) if prof else None,
            "issue_ms": host_ms(fn, *host)}


def print_times(label, eager, captured):
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    print(f"  {label} eager / captured (ms): " + "; ".join(
        f"{k[:-3]} {fmt(eager[k])} / {fmt(captured[k])}" for k in eager))


def run_captured(torch, mdt, graphs, train, train_step, names, dev):
    """The captured-steps phase.  Per op step: captured on seed 0's inputs,
    replayed on seed 1's copied into the static ones, its out and gradients
    against an eager call on seed 1's by SHA-256, and its times both ways.
    Per network (CAPTURED_NETS, at full width): the trainer's
    steps captured and eager from the same initial parameters (AdamW
    capturable both ways, cuDNN deterministic), losses and parameters bit
    for bit, or, with the library ops that use atomics named, the first
    loss within CAPTURED_NET_LIMIT and one step's gradients from the same
    parameters within CAPTURED_NET_LIMIT or CAPTURED_NOISE times two eager
    steps' parting; and the step's times both ways.  Checks that the twelve
    kernels are inside the graphs between them.  Replays count no launch,
    so the kernel table's `launches` are untouched."""
    import hashlib
    from modulated_deform_conv_tpu_torch.ops.cuda import groupnorm as gn
    t_phase = time.time()
    sha = lambda t: hashlib.sha256(  # noqa: E731
        t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    held, out = {}, {"ops": {}, "nets": {}}
    for label, (op, (ins, new)) in captured_op_cases(torch, mdt, dev).items():
        def step_fn(*leaves, op=op):
            y = op(*leaves)
            return (y.detach(),) + torch.autograd.grad((y * y).sum(), leaves)

        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        step = graphs.capture(step_fn, *leaves)
        got = [sha(t) for t in step(*new)]
        want = [sha(t) for t in step_fn(*[t.detach().clone().requires_grad_(True) for t in new])]
        same = got == want
        print(f"captured {label}: graph holds {step.kernels}; replay on seed 1 against eager: "
              + ("SHA-256 equal on out and every gradient" if same else f"DIFFERENT {got} {want}"))
        check(same, f"captured {label}: the replay's bits differ from eager")
        held[label] = step.kernels
        eager = step_times(lambda: step_fn(*leaves), wall_ms(lambda: step_fn(*leaves)))
        captured = step_times(step, wall_ms(step))
        print_times(label, eager, captured)
        chained = graphs.time_chain(step_fn, *leaves)
        dev_ms = captured["device_ms"]
        print(f"  {label} chained (n_lo {chained['n_lo']}, n_hi {chained['n_hi']}): "
              f"{chained['ms']:.4f} ms (spread {chained['spread']:.3f}) against the captured "
              "step's device time " + ("not measured" if dev_ms is None else
                                       f"{dev_ms:.4f} ms ({chained['ms'] / dev_ms:.3f}x)"))
        out["ops"][label] = {"kernels": step.kernels, "capture_s": step.capture_s,
                             "eager": eager, "captured": captured,
                             "chained": {k: chained[k] for k in ("ms", "spread", "samples")}}
        del step, leaves, ins, new
    torch.cuda.empty_cache()
    for name, cfg, arch in CAPTURED_NETS:
        kw = dict(steps=cfg["steps"], batch=cfg["batch"], width=cfg["width"],
                  classes=cfg["classes"], size=cfg["size"], device="cuda", arch=arch,
                  log=lambda s: None, **({"frames": cfg["frames"]} if "frames" in cfg else {}))
        cap = train(**kw)
        ref = train(eager=True, **kw)
        params = cap["model"].state_dict()
        own = ref["model"].state_dict()
        bits = cap["losses"] == ref["losses"] and all(torch.equal(v, own[k])
                                                      for k, v in params.items())
        worst = max(float((v - own[k]).abs().max() / own[k].abs().max().clamp_min(1e-30))
                    for k, v in params.items())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cap["losses"], ref["losses"]))
        atomics, gaps = [], ({}, {})
        if not bits:
            gaps = same_params_grad_gaps(torch, cap, ref, train_step)
            # Name the library ops of one eager step that have no
            # deterministic implementation (PyTorch warns for each).
            import warnings
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    x, y = ref["batch"]
                    train_step(ref["model"], ref["optimizer"], x, y)
                    torch.cuda.synchronize()
                finally:
                    torch.use_deterministic_algorithms(False)
            atomics = sorted({str(w.message).split(" does not have")[0] for w in caught
                              if "deterministic" in str(w.message)})
        grad_rel, eager_rel = (max(g.values(), default=0.0) for g in gaps)
        parted = sorted(n for n, g in gaps[0].items() if g > 0)
        first_rel = abs(cap["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
        print(f"captured {name}: {cfg['steps']} steps, losses {cap['losses']} (eager "
              f"{ref['losses']}); " + ("losses and parameters bit-equal to eager" if bits else
                                      f"losses within {loss_rel:.3e} (the first {first_rel:.3e}), "
                                      f"parameters within {worst:.3e} relative of eager; gradients "
                                      f"from the same parameters within {grad_rel:.3e} in "
                                      f"{len(parted)} leaves {parted[:6]} (eager against eager "
                                      f"{eager_rel:.3e}); library ops with atomics: {atomics}"))
        check(bits or (atomics and first_rel <= CAPTURED_NET_LIMIT
                       and grad_rel <= max(CAPTURED_NET_LIMIT, CAPTURED_NOISE * eager_rel)),
              f"captured {name} parts from eager: first loss {first_rel:.3e}, gradients from the "
              f"same parameters {grad_rel:.3e} (eager against eager {eager_rel:.3e}), ops with "
              f"atomics {atomics}")
        held[name] = cap["kernels"]
        print(f"captured {name}: graph holds {cap['kernels']}, values a step "
              f"{cap['step'].values}; capture {cap['capture_s']:.2f} s "
              f"({graphs.WARMUP} warm-up steps included)")
        n_values = sum(p.numel() for p in cap["model"].parameters())
        check(cap["kernels"].get("adamw") == 1,
              f"captured {name}: the AdamW update is not one launch a step")
        # Every norm on the GroupNorm pair, one launch each way.
        norms = gn.norm_calls(type(ref["model"])(
            num_classes=cfg["classes"], width=cfg["width"], device="meta"),
            tuple(ref["batch"][0].shape))
        gn_launches = {"groupnorm_fwd": len(norms), "groupnorm_bwd": len(norms)}
        check(all(cap["kernels"].get(k) == v for k, v in gn_launches.items()),
              f"captured {name}: graph holds {cap['kernels']}, want {gn_launches}")
        if arch == "resnet3d":
            # Every DCN layer on the 3D column pair, one launch each way.
            cols = {"gathermm3d_cols_fwd": DCN_LAYERS, "gathermm3d_cols_bwd": DCN_LAYERS}
            check(cap["kernels"] == {**cols, **gn_launches, "adamw": 1},
                  f"captured {name}: graph holds {cap['kernels']}, want {cols}, "
                  f"{gn_launches} and one AdamW")
        want = {"adamw": n_values,
                "groupnorm_fwd": sum(math.prod(s) for s, *_ in norms)}
        want.update(col_values(torch, ref["model"], ref["batch"][0]))
        check(cap["step"].values == want,
              f"captured {name}: values a step {cap['step'].values}, want {want}")
        step, (x, y) = cap["step"], ref["batch"]
        # Host clock: the trainer's own steps 2-N.
        eager = step_times(lambda: train_step(ref["model"], ref["optimizer"], x, y),
                           statistics.median(ref["step_s"][1:]) * 1e3, (5, 2, 1), (3, 3))
        captured = step_times(step, statistics.median(cap["step_s"][1:]) * 1e3, (5, 2, 1),
                              (3, 3))
        print_times(name, eager, captured)
        out["nets"][name] = {"kernels": cap["kernels"], "capture_s": cap["capture_s"],
                             "bit_equal": bits, "max_rel_params": worst, "atomics": atomics,
                             "eager": eager, "captured": captured}
        del cap, ref, step, params, own, x, y
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    inside = set().union(*held.values())
    print("kernels inside the captured graphs: " + "; ".join(
        f"{label}: {', '.join(sorted(k))}" for label, k in held.items()))
    missing = sorted(set(names) - inside)
    check(not missing, f"kernels in no captured graph: {missing}")
    print(f"all twelve kernels inside at least one graph; captured phase: "
          f"{time.time() - t_phase:.1f} s")
    return out


# The AdamW update: its plain version's rounding against the kernel's, a
# few units in the last place a step (tests/test_torch_port_adamw_cuda.py).
ADAMW_TOL = {"torch.float32": 2.0 ** -21, "torch.bfloat16": 2.0 ** -7}
ADAMW_KW = dict(lr=1e-3, weight_decay=1e-4)


def run_adamw(torch, mdt, aw, graphs, dev):
    """The AdamW phase.  Per type (float32, bfloat16), on DCNResNet-50's
    leaves at its published width: two eager steps of the kernel against
    its plain version on CPU copies, one launch a step; then the update's
    device time (`graphs.time_chain`: captured chains of 1 and 4 steps,
    differenced) for the kernel, torch's foreach AdamW and torch's fused
    AdamW (both capturable), beside the bound: p, g, m and v read once and
    p, m and v written once at 3.35 TB/s."""
    from modulated_deform_conv_tpu_torch.ops.cuda import lib
    t_phase = time.time()
    shapes = [tuple(p.shape) for p in mdt.DCNResNet(
        num_classes=RESNET["classes"], width=RESNET["width"], device="meta").parameters()]
    total = sum(math.prod(s) for s in shapes)
    out = {"leaves": len(shapes), "values": total}
    makers = {
        "kernel": lambda ps: aw.AdamW(ps, capturable=True, **ADAMW_KW),
        "foreach": lambda ps: torch.optim.AdamW(ps, capturable=True, foreach=True, **ADAMW_KW),
        "fused": lambda ps: torch.optim.AdamW(ps, capturable=True, fused=True, **ADAMW_KW)}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(0)
        start = [(torch.randn(s, generator=gen, device=dev) * 0.05).to(dtype) for s in shapes]
        grads = [[torch.randn(s, generator=gen, device=dev).to(dtype) for s in shapes]
                 for _ in range(2)]
        kern = [t.clone().requires_grad_() for t in start]
        plain = [t.to("cpu", copy=True).requires_grad_() for t in start]
        opts = (makers["kernel"](kern), aw.AdamW(plain, **ADAMW_KW))
        before = lib.counts()
        for g in grads:
            for p, q, gi in zip(kern, plain, g):
                p.grad, q.grad = gi, gi.cpu()
            for opt in opts:
                opt.step()
        torch.cuda.synchronize()
        after = lib.counts()
        launches = (after.launches - before.launches)["adamw"]
        values = (after.values - before.values)["adamw"]
        check((launches, values) == (2, 2 * total),
              f"AdamW {dtype}: {launches} launches, {values} values over 2 steps, want 2 "
              f"and {2 * total}")
        tol = 2 * ADAMW_TOL[str(dtype)]
        worst = max(float(((a.detach().cpu().double() - b.detach().double()).abs()
                           - tol * (b.detach().double().abs() + ADAMW_KW["lr"])).max())
                    for a, b in zip(kern, plain))
        err = max(rel_err(a.detach().cpu(), b.detach()) for a, b in zip(kern, plain))
        check(worst <= 0, f"AdamW {dtype}: kernel off its plain version by {worst:.3e} "
                          "past the bound")
        del kern, plain, opts
        nbytes = 7 * total * start[0].element_size()
        row = {"max_rel_err": err, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        for name, make in makers.items():
            leaves = [t.clone().requires_grad_() for t in start]
            for p, g in zip(leaves, grads[0]):
                p.grad = g
            opt = make(leaves)
            try:
                timed = graphs.time_chain(lambda: (opt.step(),)[1:])
            except RuntimeError as e:   # a library anchor that cannot be captured
                check(name != "kernel", f"AdamW kernel: capture failed: {e}")
                row[f"{name}_ms"], row[f"{name}_error"] = None, str(e)[:300]
            else:
                row[f"{name}_ms"], row[f"{name}_spread"] = timed["ms"], timed["spread"]
                if name == "kernel":
                    check(timed["kernels"]["lo"] == {"adamw": 1},
                          f"AdamW kernel: graph holds {timed['kernels']['lo']}")
            del opt, leaves
            torch.cuda.empty_cache()
        ms = row["kernel_ms"]
        row["hbm_share"] = nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
        print(f"AdamW on DCNResNet-50's {len(shapes)} leaves ({total} values), {dtype}: kernel "
              f"{ms:.4f} ms (spread {row['kernel_spread']:.3f}), bound {row['bound_ms']:.4f} ms "
              f"({nbytes / 1e9:.3f} GB; {row['hbm_share']:.1%} of 3.35 TB/s); torch foreach "
              f"{fmt(row['foreach_ms'])}, torch fused {fmt(row['fused_ms'])}; max rel err "
              f"against the plain version {err:.3e}")
        out[str(dtype).split(".")[1]] = row
        del start, grads
        torch.cuda.empty_cache()
    print(f"AdamW phase: {time.time() - t_phase:.1f} s")
    return out


# GroupNorm with its epilogue: the kernels' forward against torch's
# GroupNorm (+ identity) + ReLU in float32, max|d| / max|torch|, and their
# backward against their plain version in float64 from the kernels' own y
# (torch's y may take another sign where it rounds to about 0, and flip
# the ReLU's mask there), dx over the scale of its largest term, rstd
# |gamma| |dy|: sums in float32 in other orders.
GROUPNORM_LIMIT = 1e-4
# (label, network, input of the cell, timed backward too)
GROUPNORM_CELLS = (
    ("DCNResNet-50 B=8", lambda mdt: mdt.DCNResNet(device="meta"), (8, 3, 224, 224), True),
    ("DCNResNet3d-50 B=32", lambda mdt: mdt.DCNResNet3d(device="meta"), (32, 3, 16, 112, 112),
     True),
    ("DCNResNet-50 B=1", lambda mdt: mdt.DCNResNet(device="meta"), (1, 3, 224, 224), False))


def run_groupnorm(torch, mdt, graphs, dev):
    """The GroupNorm phase.  Per cell (GROUPNORM_CELLS), at each distinct
    layer of its 40 norms with the layer's residual add and ReLU, float32:
    the kernels against torch's GroupNorm + add + ReLU forward and their
    plain version backward (GROUPNORM_LIMIT), then the device time (`graphs.time_chain`) of the forward and of the
    forward with the backward, the kernels' and torch's, beside the bound:
    x (and the identity) read and y written once forward; dy, x (y with
    the ReLU) read and dx (and d_identity) written once backward, at 3.35
    TB/s.  Sums over the cell's 40 layers."""
    import torch.nn.functional as F
    from modulated_deform_conv_tpu_torch.ops.cuda import groupnorm as gn
    t_phase = time.time()
    out = {}

    def torch_op(x, G, w, b, idt, relu):
        y = F.group_norm(x, G, w, b, 1e-6)
        y = y if idt is None else y + idt
        return F.relu(y) if relu else y

    def fused_op(x, G, w, b, idt, relu):
        return gn.group_norm_act(x, G, w, b, 1e-6, idt, relu)

    for label, make, shape, backward in GROUPNORM_CELLS:
        layers = gn.norm_calls(make(mdt), shape)
        check(len(layers) == 40, f"{label}: {len(layers)} norms, want 40")
        sums = {k: 0.0 for k in ("fused_fwd_ms", "torch_fwd_ms", "fused_step_ms",
                                 "torch_step_ms", "bound_fwd_ms", "bound_step_ms")}
        rows, worst = [], 0.0
        for key in sorted(set(layers)):
            n = layers.count(key)
            xs, G, ident, relu = key
            gen = torch.Generator(device=dev).manual_seed(len(rows))
            t = lambda *sz: torch.randn(sz, generator=gen, device=dev)  # noqa: E731
            leaves = [t(*xs) * 1.5 + 0.3, t(xs[1]), t(xs[1]), t(*xs) if ident else None]
            leaves = [None if v is None else v.requires_grad_(True) for v in leaves]
            dy = t(*xs)
            live = [v for v in leaves if v is not None]
            row = {"shape": list(xs), "groups": G, "identity": ident, "relu": relu, "count": n}
            x_, w_, b_ = (v.detach() for v in leaves[:3])
            idt_ = leaves[3].detach() if ident else None
            y, mean, rstd = gn.groupnorm_fwd(x_, G, w_, b_, 1e-6, idt_, relu)
            errs = {"y": rel_err(y, torch_op(x_, G, w_, b_, idt_, relu))}
            if backward:
                got = gn.groupnorm_bwd(dy, x_, y, mean, rstd, w_, G, relu, ident)
                want = gn.group_norm_backward_reference(
                    dy.double(), x_.double(), y, w_.double(), G, 1e-6, relu, ident)
                scale = float(rstd.max()) * float(w_.abs().max()) * float(dy.abs().max())
                errs["dx"] = float((got[0].double() - want[0]).abs().max()) / scale
                errs.update((k, rel_err(a, b)) for k, a, b in zip(("dw", "db", "did"), got[1:],
                                                                 want[1:]) if a is not None)
            row["rel_err"] = errs
            worst = max(worst, *errs.values())
            fwd_bytes = (2 + ident) * math.prod(xs) * 4
            bwd_bytes = (3 + relu + ident) * math.prod(xs) * 4
            row["bound_fwd_ms"] = fwd_bytes / HBM_BYTES_PER_S * 1e3
            row["bound_step_ms"] = (fwd_bytes + bwd_bytes) / HBM_BYTES_PER_S * 1e3
            for name, op in (("fused", fused_op), ("torch", torch_op)):
                with torch.no_grad():
                    row[f"{name}_fwd_ms"] = graphs.time_chain(
                        lambda *a, op=op: (op(a[0], G, a[1], a[2], a[3] if ident else None, relu),),
                        *[v.detach() for v in live])["ms"]
                if backward:
                    def step(*a, op=op):
                        y = op(a[0], G, a[1], a[2], a[3] if ident else None, relu)
                        return torch.autograd.grad(y, a, dy)
                    row[f"{name}_step_ms"] = graphs.time_chain(step, *live)["ms"]
            for k in sums:
                if k in row:
                    sums[k] += n * row[k]
            rows.append(row)
            del leaves, live, dy, x_, w_, b_, idt_, y, mean, rstd
            torch.cuda.empty_cache()
        check(worst <= GROUPNORM_LIMIT,
              f"{label}: GroupNorm kernels off torch by {worst:.3e} (limit {GROUPNORM_LIMIT})")
        out[label] = {"layers": rows, "max_rel_err": worst,
                      **{k: v for k, v in sums.items() if v}}
        fmt = lambda k: f"{sums[k]:.4f}" if sums[k] else "-"  # noqa: E731
        print(f"GroupNorm {label}, 40 layers float32: forward kernel {fmt('fused_fwd_ms')} ms, "
              f"torch {fmt('torch_fwd_ms')} ms, bound {fmt('bound_fwd_ms')} ms; forward + "
              f"backward kernels {fmt('fused_step_ms')} ms, torch {fmt('torch_step_ms')} ms, "
              f"bound {fmt('bound_step_ms')} ms; max rel err against torch {worst:.3e}")
        for r in rows:
            print(f"  {r['shape']} G={r['groups']} id={r['identity']} relu={r['relu']} x{r['count']}: "
                  + ", ".join(f"{k} {r[k]:.4f}" for k in r if k.endswith("_ms")))
    print(f"GroupNorm phase: {time.time() - t_phase:.1f} s")
    return out


def main() -> int:
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import modulated_deform_conv_tpu_torch as mdt
        from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
            train, train_step)
        from modulated_deform_conv_tpu_torch.ops.cuda import adamw as aw
        from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
        from modulated_deform_conv_tpu_torch.ops.cuda import lib
        from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
        from modulated_deform_conv_tpu_torch.parallel import sharding as sh
        from modulated_deform_conv_tpu_torch.utils import graphs
        from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    check("jax" not in sys.modules, "the port imported jax")

    # Phase 1: the card, and the TF32 switches the plain versions depend on.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = True          # dense anchor in TF32
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    # family -> (forward, its plain version, backward, its plain version)
    families = {"shiftblend": (sb.fwd, sb.shiftblend_fwd_reference,
                               sb.bwd, sb.shiftblend_bwd_reference),
                "gathermm": (gm.fused_fwd, gm.gathermm_fwd_reference,
                             gm.fused_bwd, gm.gathermm_bwd_reference)}
    families3d = {"shiftblend3d": (sb.fwd, sb.shiftblend_fwd_reference,
                                   sb.bwd, sb.shiftblend_bwd_reference),
                  "gathermm3d": (gm.fused_fwd, gm.gathermm_fwd_reference,
                                 gm.fused_bwd, gm.gathermm_bwd_reference)}
    kernels = {}
    for fam, (fwd, fwd_ref, bwd, bwd_ref) in {**families, **families3d}.items():
        kernels[f"{fam}_fwd"] = (fwd, fwd_ref)
        kernels[f"{fam}_bwd"] = (bwd, bwd_ref)
    for fam in ("gathermm_cols", "gathermm3d_cols"):
        kernels[f"{fam}_fwd"] = (gm.cols_fwd, gm.gathermm_cols_reference)
        kernels[f"{fam}_bwd"] = (gm.cols_bwd, gm.gathermm_cols_bwd_reference)
    # The launch table at the last reset: counts() gives each kernel's
    # launches since.
    base = lib.counts().launches

    def reset():
        nonlocal base
        base = lib.counts().launches

    def counts():
        now = lib.counts().launches
        return {n: now[n] - base[n] for n in kernels}

    # Phase 2: build the twelve kernels, the AdamW update, the GroupNorm
    # pair and calibrate's FMA probe from the sources, in parallel.
    t0 = time.time()
    logs = lib.build(lib.sources(), verbose=True)
    print(f"build: {time.time() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    x, off, mask, w, bias = cfg2_inputs(torch, dev)
    spec = DeformConvSpec.make(2, KS, 1, 1, 1, G, DG, modulated=True)
    extra = {"shiftblend": (BOUND,), "gathermm": ()}
    results = {n: {"rel_err": {}} for n in kernels}

    def op(*ins, **kw):
        return mdt.modulated_deform_conv2d(*ins, 1, 1, 1, G, DG, **kw)

    # Which pair "auto" takes at config 2, bounded and general, from the
    # card's device profile (utils/device.py).
    print(f"device profile: {current_profile_of(x)}")
    cfg2_pairs = {"bounded": auto_pair(x, spec, O, BOUND), "general": auto_pair(x, spec, O)}
    print(f"config 2 under 'auto': bounded {cfg2_pairs['bounded']}, general "
          f"{cfg2_pairs['general']}")
    main_launches = {n: 0 for n in kernels}

    def add_main(c):
        """Count a main-path run's launches into the kernel table's."""
        for n, v in c.items():
            main_launches[n] += v

    # Phase 3: main path 1, the forward at config 2 through the public op.
    with torch.no_grad():
        reset()
        out_bounded = op(x, off, mask, w, bias, impl="auto", offset_bound=BOUND)
        out_general = op(x, off, mask, w, bias, impl="auto")
        torch.cuda.synchronize()
        fwd_launches = counts()
        add_main(fwd_launches)
        print(f"forward path launches: {fwd_launches}")
        for n in (f"{p}_fwd" for p in cfg2_pairs.values()):
            check(fwd_launches[n] >= 1, f"{n} was not launched on the forward path")
        ref = op(x, off, mask, w, bias, impl="torch")
        for label, out in (("bounded", out_bounded), ("general", out_general)):
            check(out.shape == (B, O, H, W), f"{label} output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"{label} output not finite")
            e = rel_err(out, ref)
            print(f"forward path {label} vs impl='torch': rel err {e:.3e}")
            check(e <= LIMITS[MAIN_PRECISION], f"forward path {label} disagrees: {e:.3e}")
        del out_bounded, out_general

    # Phase 4: main path 2, the training step of bench.py at config 2:
    # grads of sum(out^2) in all five inputs, through impl="auto".
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, off, mask, w, bias)]

    def cfg2_step(**kw):
        out = op(*leaves, **kw)
        return torch.autograd.grad((out * out).sum(), leaves)

    step_grads = {}
    for label, kw in (("bounded", dict(offset_bound=BOUND)), ("general", {})):
        fam = cfg2_pairs[label]
        reset()
        step_grads[label] = cfg2_step(impl="auto", **kw)
        torch.cuda.synchronize()
        lc = counts()
        add_main(lc)
        print(f"training-step path {label} launches: {lc}")
        for n in (f"{fam}_fwd", f"{fam}_bwd"):
            check(lc[n] == 1, f"{n} was not launched once on the {label} training step")
    g_ref = cfg2_step(impl="torch")
    names5 = ("x", "offset", "mask", "weight", "bias")
    for label, kw in (("bounded", dict(offset_bound=BOUND)), ("general", {})):
        grads = step_grads[label]
        errs = {n: rel_err(g, r) for n, g, r in zip(names5, grads, g_ref)}
        print(f"training step {label} vs impl='torch': "
              + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))
        for n, e in errs.items():
            check(bool(torch.isfinite(grads[names5.index(n)]).all()), f"{label} grad_{n} not finite")
            check(e <= LIMITS[MAIN_PRECISION], f"training step {label} grad_{n} disagrees: {e:.3e}")
        again = cfg2_step(impl="auto", **kw)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"training step {label}: two backward runs differ")
        print(f"training step {label}: two backward runs bitwise equal")
    del step_grads, grads, again, g_ref

    # Phase 4b: main path 2b, BASELINE config 1 with and without its bound,
    # and a small volume, through impl="auto" (PLAIN_CASES).
    for c in run_plain_cases(torch, mdt, reset, counts, dev).values():
        add_main(c)

    with torch.no_grad():
        # Phase 5: each kernel against its plain version, every mode, at
        # config 2 and on the small cases.
        gout = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (B, O, H, W)).astype(np.float32)).to(dev)
        for fam, (fwd, fwd_ref, bwd, bwd_ref) in families.items():
            for prec, limit in LIMITS.items():
                args = (x, off, mask, w, bias, spec, prec, *extra[fam])
                got, want = fwd(*args), fwd_ref(*args)
                e = rel_err(got, want)
                results[f"{fam}_fwd"]["rel_err"][prec] = e
                if prec == MAIN_PRECISION:
                    results[f"{fam}_fwd"]["max_abs_err"] = float((got - want).abs().max())
                print(f"{fam}_fwd cfg2 {prec}: rel err {e:.3e} (limit {limit:g})")
                check(e <= limit, f"{fam}_fwd {prec} disagrees with its plain version")
                del got, want
                bargs = (x, off, mask, w, gout, spec, prec, *extra[fam])
                got, want = bwd(*bargs), bwd_ref(*bargs)
                errs = grad_rel_errs(got, want)
                results[f"{fam}_bwd"]["rel_err"][prec] = errs
                if prec == MAIN_PRECISION:
                    results[f"{fam}_bwd"]["max_abs_err"] = max_abs(got, want)
                print(f"{fam}_bwd cfg2 {prec}: "
                      + " ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (limit {limit:g})")
                for n, e in errs.items():
                    check(e <= limit, f"{fam}_bwd {prec} grad_{n} disagrees: {e:.3e}")
                del got, want
        for fam, sspec, args, sgout, bound in small_cases(torch, dev):
            fwd, fwd_ref, bwd, bwd_ref = families[fam]
            ext = (bound,) if bound is not None else ()
            xs, offs, masks, ws, _ = args
            for prec, limit in LIMITS.items():
                e = rel_err(fwd(*args, sspec, prec, *ext), fwd_ref(*args, sspec, prec, *ext))
                check(e <= limit, f"{fam}_fwd small case {sspec} {prec}: rel err {e:.3e}")
                bargs = (xs, offs, masks, ws, sgout, sspec, prec, *ext)
                for n, e in grad_rel_errs(bwd(*bargs), bwd_ref(*bargs)).items():
                    if e is not None:
                        check(e <= limit, f"{fam}_bwd small case {sspec} {prec} grad_{n}: "
                              f"rel err {e:.3e}")
            print(f"{fam} small case k={sspec.kernel} s={sspec.stride} d={sspec.dilation} "
                  f"g={sspec.groups} dg={sspec.deformable_groups} bound={bound} "
                  f"max|off|={float(offs.abs().max()):.1f} mask={masks is not None}: fwd + bwd ok")
        # bf16 x with fp32 offset and mask through the entry point: mixed
        # activation types take the upcast route, the result in bf16.
        xb = x.to(torch.bfloat16)
        yb = mdt.modulated_deform_conv2d(xb, off, mask, w, bias, 1, 1, 1, G, DG,
                                         impl="cuda", offset_bound=BOUND)
        check(yb.dtype == torch.bfloat16, f"bf16 input gave {yb.dtype}")
        e = rel_err(yb, ref)
        print(f"bf16 input through impl='cuda': rel err {e:.3e} vs fp32 reference")
        check(e <= LIMITS["bfloat16"], "bf16 input disagrees")

        # Phase 6: the Pack module at config 2, with and without the bound.
        torch.manual_seed(0)
        for bound, label in ((BOUND, "bounded"), (None, "general")):
            want_kernel = f"{cfg2_pairs[label]}_fwd"
            mod = mdt.ModulatedDeformConv2dPack(
                C, O, KS, padding=1, groups=G, deformable_groups=DG,
                offset_bound=bound, device="cuda")
            reset()
            y = mod(x)
            torch.cuda.synchronize()
            lc = counts()
            check(lc[want_kernel] >= 1, f"Pack (bound={bound}) did not launch {want_kernel}")
            check(y.shape == (B, O, H, W) and bool(torch.isfinite(y).all()),
                  f"Pack (bound={bound}) output bad")
            p_off, p_mask = mod.conv_offset(x), mod.conv_mask(x)
            ext = (bound,) if bound is not None else ()
            if want_kernel == "gathermm_cols_fwd":
                # The columns path's plain version is the plain op's own.
                want = op(x, p_off, p_mask, mod.weight, mod.bias, impl="torch")
            else:
                want = kernels[want_kernel][1](x, p_off, p_mask, mod.weight, mod.bias, spec,
                                               MAIN_PRECISION, *ext)
            e = rel_err(y, want)
            print(f"Pack bound={bound}: launches {lc}, rel err {e:.3e}, "
                  f"max|offset| {float(p_off.abs().max()):.3f}")
            check(e <= LIMITS[MAIN_PRECISION], f"Pack (bound={bound}) disagrees")

        # Phase 7: times at config 2, in the main path's precision mode.
        K = KS * KS
        f32 = 4
        in_bytes = f32 * (x.numel() + off.numel() + mask.numel() + w.numel())
        gemm_ops = 2 * B * H * W * O * (C // G) * K
        work = {  # bytes each input read once and each output written once
            "fwd": (in_bytes + f32 * (bias.numel() + B * O * H * W), gemm_ops),
            "bwd": (2 * in_bytes + f32 * gout.numel(), 2 * gemm_ops)}
        bounds = {}
        for kind, (n_bytes, n_ops) in work.items():
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / PEAK_OPS[MAIN_PRECISION] * 1e3
            bounds[kind] = max((t_bytes, "bytes"), (t_ops, "operations"))
            print(f"cfg2 {kind} work: {n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP; bound "
                  f"{bounds[kind][0] * 1e3:.2f} us by {bounds[kind][1]} (fp32 FMA rate: "
                  f"{n_ops / PEAK_OPS['float32'] * 1e6:.1f} us)")
        anchors = {
            "fwd": time_ms(lambda: torch.nn.functional.conv2d(x, w, bias, 1, 1, 1, G)),
            "bwd": time_ms(lambda: torch.ops.aten.convolution_backward(
                gout, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], G,
                [True, True, False]))}
        for fam, (fwd, fwd_ref, bwd, bwd_ref) in families.items():
            for kind, fn, ref_fn, fifth in (("fwd", fwd, fwd_ref, bias),
                                            ("bwd", bwd, bwd_ref, gout)):
                name = f"{fam}_{kind}"
                args = (x, off, mask, w, fifth, spec, MAIN_PRECISION, *extra[fam])
                ms = time_ms(lambda: fn(*args))
                plain_ms = time_ms(lambda: ref_fn(*args))
                results[name].update(ms=ms, plain_ms=plain_ms)
                print(f"{name}: {ms:.4f} ms (previous release {PREV_MS[name]:.4f} ms; plain "
                      f"{plain_ms:.3f} ms, dense conv {kind} anchor {anchors[kind]:.4f} ms, "
                      f"bound {bounds[kind][0]:.4f} ms)")
    # The steps on CUDA events (back-to-back, so the host's enqueue of a step
    # overlaps the device's run of the previous), in device time (the sum
    # of the kernels one step launches, torch.profiler) and in host time
    # (issuing one step): where the first exceeds the second, the host sets
    # the step's time.
    steps, steps_device, steps_host = {}, {}, {}
    for label, kw in (("bounded", dict(impl="auto", offset_bound=BOUND)),
                      ("general", dict(impl="auto")), ("plain", dict(impl="torch"))):
        steps[label] = time_ms(lambda: cfg2_step(**kw))
        prev = PREV_STEP_MS.get(f"cfg2 {label}")
        print(f"cfg2 training step (fwd + bwd of sum(out^2), five grads) {label}: "
              f"{steps[label]:.4f} ms" + (f" (previous release {prev:.4f} ms)" if prev else ""))
        if label != "plain":
            prof = device_time_by_kernel(lambda: cfg2_step(**kw))
            steps_device[label] = sum(prof.values()) if prof else None
            steps_host[label] = host_ms(lambda: cfg2_step(**kw))
            print(f"cfg2 training step {label}: host {steps_host[label]:.4f} ms to issue")
            print_breakdown(f"cfg2 training step {label} profile", prof)
    # Phase 7b: the shift-blend forward's two routes side by side.
    routes = time_routes(torch, sb, dev)
    # Where the device time of the forward and the backward goes, kernel by
    # kernel, and their times in the other two modes.
    with torch.no_grad():
        for fam, (fwd, _, _, _) in families.items():
            fargs = (x, off, mask, w, bias, spec, MAIN_PRECISION, *extra[fam])
            print_breakdown(f"{fam}_fwd cfg2 profile", device_time_by_kernel(lambda: fwd(*fargs)))
            by_mode = {prec: time_ms(lambda: fwd(x, off, mask, w, bias, spec, prec, *extra[fam]))
                       for prec in LIMITS}
            results[f"{fam}_fwd"]["ms_by_mode"] = by_mode
            print(f"{fam}_fwd cfg2 by mode: " + " ".join(f"{p} {ms:.4f} ms" for p, ms in by_mode.items()))
        for fam, (_, _, bwd, _) in families.items():
            args = (x, off, mask, w, gout, spec, MAIN_PRECISION, *extra[fam])
            print_breakdown(f"{fam}_bwd cfg2 profile", device_time_by_kernel(lambda: bwd(*args)))
            by_mode = {}
            for prec in LIMITS:
                margs = (x, off, mask, w, gout, spec, prec, *extra[fam])
                by_mode[prec] = time_ms(lambda: bwd(*margs))
            results[f"{fam}_bwd"]["ms_by_mode"] = by_mode
            print(f"{fam}_bwd cfg2 by mode: " + " ".join(f"{p} {ms:.4f} ms" for p, ms in by_mode.items()))
    del leaves

    # Phase 8: main path 3, DCNResNet-50 trained on the card by the
    # in-package trainer.  Hooks on its 13 DCN layers record, at the first
    # step (zero-init offsets: every tap on the integer grid) and the last,
    # each layer's inputs and output cotangent; recording launches nothing.
    r = RESNET
    reset()
    res, recorded = train_recorded(
        torch, train, mdt.ModulatedDeformConv2dPack, DeformConvSpec, r["steps"],
        batch=r["batch"], width=r["width"], classes=r["classes"], size=r["size"])
    net_launches = counts()
    add_main(net_launches)
    print(f"DCNResNet-50 launches over {r['steps']} steps: {net_launches}")
    check(len([rec for rec in recorded if rec["step"] == 0]) == DCN_LAYERS,
          "DCNResNet-50: not every DCN layer recorded")
    want = recorded_pairs(recorded, r["steps"], kernels)
    check(net_launches == want, f"DCNResNet-50 launches {launched(net_launches)}, want the "
          f"profile's pairs {launched(want)}")
    check(all(np.isfinite(res["losses"])), "DCNResNet loss not finite")
    step_ms = statistics.median(res["step_s"][1:]) * 1e3
    print(f"DCNResNet-50 width {r['width']} B={r['batch']} {r['size']}x{r['size']}: "
          f"loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, step {step_ms:.2f} ms "
          f"(median of steps 2-{r['steps']}; first {res['step_s'][0] * 1e3:.1f} ms)")
    # The general kernels against their plain versions on the recorded
    # inputs of every DCN layer, every mode.
    check_recorded(torch, recorded, DCN_LAYERS, families["gathermm"], "DCNResNet")
    if net_launches["gathermm_cols_fwd"]:
        check_recorded_cols(torch, recorded, gm, "DCNResNet-50")
    resnet_fwd = time_recorded(torch, recorded, gm.fused_fwd, "DCNResNet-50")["fwd"]
    results["gathermm_fwd"].update(resnet50_layers_ms=resnet_fwd["ms"],
                                   resnet50_layers_device_ms=resnet_fwd["device_ms"],
                                   resnet50_layers_bound_ms=resnet_fwd["bound_ms"])
    del recorded
    profile_train_step(res, train_step, "DCNResNet-50")
    del res

    # Phases 9-12: the 3D paths, BASELINE configs 3 and 4 and DCNVideoNet.
    torch.cuda.empty_cache()
    r3 = run_3d(torch, mdt, families3d, reset, counts, dev)
    for c in r3["main_launches"].values():
        add_main(c)
    torch.cuda.empty_cache()
    v = VIDEO
    reset()
    res, recorded = train_recorded(
        torch, train, mdt.ModulatedDeformConv3dPack, DeformConvSpec, v["steps"],
        batch=v["batch"], width=v["width"], classes=v["classes"], size=v["size"],
        arch="video", frames=v["frames"])
    video_launches = counts()
    add_main(video_launches)
    print(f"DCNVideoNet launches over {v['steps']} steps: {video_launches}")
    want = recorded_pairs(recorded, v["steps"], kernels)
    check(video_launches == want, f"DCNVideoNet launches {launched(video_launches)}, want the "
          f"profile's pairs {launched(want)}")
    check(all(np.isfinite(res["losses"])) and res["losses"][-1] < res["losses"][0],
          f"DCNVideoNet loss did not fall: {res['losses']}")
    video_ms = statistics.median(res["step_s"][1:]) * 1e3
    print(f"DCNVideoNet width {v['width']} {v['classes']} classes B={v['batch']} "
          f"{v['frames']}x{v['size']}x{v['size']}: loss {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f}, step {video_ms:.2f} ms (median of steps 2-{v['steps']}; "
          f"first {res['step_s'][0] * 1e3:.1f} ms)")
    print(f"DCNVideoNet DCN launches over {v['steps']} steps: {launched(video_launches)}")
    check_recorded(torch, recorded, VIDEO_DCN_LAYERS, families3d["gathermm3d"], "DCNVideoNet")
    if video_launches["gathermm3d_cols_fwd"]:
        check_recorded_cols(torch, recorded, gm, "DCNVideoNet")
    video_dcn = time_recorded(torch, recorded, gm.fused_fwd, "DCNVideoNet",
                              bwd=gm.fused_bwd)
    print("DCNVideoNet: its DCN calls a step (forward and backward of each layer) "
          f"{sum(t['ms'] for t in video_dcn.values()):.4f} ms on events, "
          f"{sum(t['device_ms'] for t in video_dcn.values()):.4f} ms device, against a bound of "
          f"{sum(t['bound_ms'] for t in video_dcn.values()):.4f} ms")
    for kind, t in video_dcn.items():
        r3["rows"][f"gathermm3d_{kind}"].update(videonet_layers_ms=t["ms"],
                                                videonet_layers_device_ms=t["device_ms"],
                                                videonet_layers_bound_ms=t["bound_ms"])
    del recorded
    profile_train_step(res, train_step, "DCNVideoNet")
    del res

    # Phase 13: DCNResNet3d-50 at the cell r3d50-k400-train's size, every
    # DCN layer on the 3D column pair.
    torch.cuda.empty_cache()
    add_main(run_resnet3d(torch, mdt, train, gm, DeformConvSpec, reset, counts, kernels))

    # Phases 14-16: the unfused columns path.
    torch.cuda.empty_cache()
    r5 = run_columns(torch, mdt, gm, reset, counts, dev)
    sweep5 = r5["launches"]["cfg5"]
    for c in (sweep5["fwd"], sweep5["step"], r5["launches"]["cols3d"]["fwd"],
              r5["launches"]["cols3d"]["step"]):
        add_main(c)

    # Phase 18: every kernel's unsharded launches give the bits of the tree
    # before the gather kernels' block mode: the default gate (-1, S) that
    # the geometry now carries changes nothing.
    torch.cuda.empty_cache()
    digests = unsharded_digests(torch, gm, sb, dev)
    same = {n: {m: d == PREV_DIGESTS.get(n, {}).get(m) for m, d in by.items()}
            for n, by in digests.items()}
    print("unsharded launches, SHA-256 against the previous tree's: " + "; ".join(
        f"{n} " + "/".join("same" if s else "DIFFERENT" for s in by.values())
        for n, by in same.items()))
    check(all(all(by.values()) for by in same.values()),
          f"unsharded bits changed: {json.dumps(digests)}")

    # Phase 19: the sharded phase (the sharding layer's per-shard function
    # on every shard of six layouts: shift-blend's lead mode and the gather
    # kernels' block mode), and the public sharded entry on a one-rank NCCL
    # mesh.
    torch.cuda.empty_cache()
    sharded, sharded_auto = run_sharded(torch, sh, sb, reset, counts, dev)
    for c in sharded_auto.values():
        add_main(c)
    nccl_one_rank(torch, mdt, dev)

    # Phase 20: the device layer.  calibrate --quick: the raw rates, and one
    # point either side of each reference value, where the card's profile
    # parts from the JAX package's; a point that contradicts the committed
    # profile by more than its spread fails.
    calibration = run_calibration(torch, dev)
    # Phase 21: the smoke example through the kernels.
    run_smoke_example(torch, reset, counts, dev)
    # Phase 22: autotune of the column forward's knobs at config 5 c4.
    tuned = run_autotune(torch, gm, dev)
    # Phase 23: bf16 activations as they are on every kernel path.
    torch.cuda.empty_cache()
    bf16, bf16_pack = run_bf16(torch, mdt, gm, sb, sh, lib, kernels, reset, counts, dev)
    add_main(bf16_pack)
    # Phase 24: the captured steps (CUDA graphs through the twelve kernels).
    torch.cuda.empty_cache()
    captured = run_captured(torch, mdt, graphs, train, train_step, list(kernels), dev)
    # Phase 25: the trainer's AdamW update, against its plain version and
    # timed beside torch's foreach and fused AdamW.
    torch.cuda.empty_cache()
    adamw_times = run_adamw(torch, mdt, aw, graphs, dev)
    # Phase 26: GroupNorm with its epilogue, against torch's and timed
    # beside it at every norm of the three cells.
    torch.cuda.empty_cache()
    groupnorm_times = run_groupnorm(torch, mdt, graphs, dev)

    # Phase 17: the kernel table.  The 2D column kernels' row is config 5's
    # c4 layer, the 3D one the 3D columns case; `launches` sums every
    # main-path run's (config 2's forward and step, config 1 and the small
    # volume, both networks, configs 3-5, the 3D columns case, the sharded
    # layouts under "auto", the bf16 Pack); the bf16 phase's cases, which
    # call the entries with a fixed kernel family, are not counted.
    table = []
    for n in kernels:
        kind = n.rsplit("_", 1)[1]
        if n.startswith("gathermm_cols"):
            row = r5["rows"]["c4"][n]
            for lay in ("c5", "c3"):
                if lay in r5["rows"]:
                    c_ = r5["rows"][lay][n]
                    row.update({f"{k}_cfg5_{lay}": c_[k] for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms", "gemm_ms", "fused_pair_ms",
                        "dense_conv_anchor_ms", "max_abs_err", "split_ms", "device_ms")
                        if k in c_})
        elif n.startswith("gathermm3d_cols"):
            row = r5["rows"]["3d"][n]
        elif n in r3["rows"]:
            row = r3["rows"][n]
        else:
            row = dict(max_abs_err=results[n]["max_abs_err"], ms=results[n]["ms"],
                       plain_ms=results[n]["plain_ms"], bound_ms=bounds[kind][0],
                       bound_by=bounds[kind][1], at="cfg2 B=8",
                       rel_err=results[n]["rel_err"])
            for k in ("ms_by_mode", "resnet50_layers_ms", "resnet50_layers_device_ms",
                      "resnet50_layers_bound_ms"):
                if k in results[n]:
                    row[k] = results[n][k]
            if n == "gathermm_fwd":
                c3 = r5["times"]["cfg5_c3"]
                row.update(ms_cfg5_c3=c3["gathermm_fwd"], bound_ms_cfg5_c3=c3["gathermm_fwd_bound"])
            row[f"dense_conv_{kind}_anchor_ms"] = anchors[kind]
        check(main_launches[n] >= 1, f"{n} was launched on no main path of this run")
        row.pop("launches", None)
        row["bf16"] = bf16["rows"][n]
        table.append({
            "name": n, "route": "cuda",
            "source": f"modulated_deform_conv_tpu_torch/csrc/{n}.cu",
            "replaces": REPLACES[n], "launches": main_launches[n],
            "max_abs_err": row.pop("max_abs_err"), "ms": row.pop("ms"),
            "plain_ms": row.pop("plain_ms"), "bound_ms": row.pop("bound_ms"),
            "bound_by": row.pop("bound_by"), "library_ms": row.pop("library_ms", None), **row,
            "precision": MAIN_PRECISION, "resnet_launches": net_launches[n],
            "videonet_launches": video_launches[n],
            "cfg5_launches": sweep5["fwd" if kind == "fwd" else "step"][n],
            **({"sharded_launches": sum(c["launches"] for c in sharded[n].values()),
                "sharded": sharded[n]} if n in sharded else {})})
    print("every row against the previous release (ms, this run / previous): " + "; ".join(
        f"{r['name']} {r['ms']:.4f} / {PREV_MS[r['name']]:.4f} ({r['ms'] / PREV_MS[r['name']]:.3f}x)"
        for r in table))
    print(json.dumps({"kernels": table, "cfg2_train_step_ms": steps,
                      "cfg2_train_step_device_ms": steps_device, "cfg2_train_step_host_ms": steps_host,
                      "shiftblend_fwd_routes_ms": routes,
                      "dcn_resnet50_step_ms": step_ms, "train_step3d_ms": r3["steps"],
                      "both_kernels3d_ms": r3["cross"], "dcn_videonet_step_ms": video_ms,
                      "columns_path_ms": r5["times"], "calibration": calibration,
                      "autotune_cfg5_c4": tuned, "bf16": bf16, "captured": captured,
                      "adamw": adamw_times, "groupnorm": groupnorm_times}))
    print(f"chip_smoke total: {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
