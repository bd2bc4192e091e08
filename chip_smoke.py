#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device report (name, power limit);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``;
  3. each attention kernel against its plain PyTorch version at
     SmolLM-360M's head geometry, at Zamba2-1.2B's (MHA, 32 heads), at
     Granite-3.0-2B's (32 heads, 8 KV heads), at head dim 16 (the
     smoke configs' heads) and at head dim 128 (phase 13's models: 32/8,
     48/8 and 28/4 heads at S = 512, Mixtral's 4,096-token window at
     S = 6,144, and B2's lse), the Mamba-2 chunked scan
     against its plain version at Zamba2's full-width heads, the mLSTM
     chunkwise scan against its plain version at xLSTM-1.3B's (H=4,
     P=1024), and both entries of the SL boundary quantizer (codes and
     scales; the fused quantize-dequantize) against their plain versions
     bit for bit at the training path's shapes, as row-major rows and as
     the channel-major NHWC view of NCHW memory that the conv stages hand
     over, with each kernel's time, bound, plain time and library
     yardstick (and their ratios), the quantizer's device time beside
     that of a copy of its input, the device time of each stage of the
     two scans in bf16, and the split count of flash decode, whose two
     runs must agree bit for bit;
  4. full-width SmolLM-360M split-model serving (cut at unit 16) through
     both attention kernels: launch counts, split == unsplit greedy
     tokens, one decode step's logits on the kernel path against the
     plain path;
  5. the paper's training loop: a 25-satellite Table-I ring training
     full-width ResNet-18 (224 px, cut l2, batch 8, SGD) with the int8
     boundary through the fused quantizer (exactly 2 launches per SL
     step, no copy: one kernel per crossing), finite losses, the metered
     boundary payload, one step's loss on the kernel path against the
     plain path, step times and a profile; then one autoencoder pass at
     224 px;
  6. full-width Zamba2-1.2B split-model serving (cut at unit 3) through
     the scan kernel (prefill) and both attention kernels (the shared
     block): launch counts, split == unsplit greedy tokens, one prefill's
     and one decode step's logits on the kernel path against the plain
     path, times and profiles;
  7. full-width xLSTM-1.3B split-model serving (cut at unit 3) through
     the mLSTM scan kernel (prefill; decode and the sLSTM recurrence are
     plain PyTorch): phase 6's checks, no kernel launch in a decode step,
     and the f32 prefill logits held within the spread of two exact
     mLSTM chunkings instead of 1e-3;
  8. the device-resident closed loop (repro_torch.sim): (a) one revolution
     of the Table-I plane training full-width ResNet-18 (224 px, cut l2,
     batch 8, int8 boundary, SGD) on batches generated on the card, 6 of
     8 executed steps a pass valid and two satellites below reserve, the
     device engine against the host engine on the same provider (equal
     actions, losses, batteries and energies at the reference's
     host-vs-device tolerances), no host sync inside the revolution (the
     engine runs it under sync-debug mode "error"), 2 quantizer launches
     per executed step and no copy, with passes/s, steps/s, card time and
     idle share per revolution, batch generation and plan solve times;
     (b) the reference example's 1000-satellite ring (autoencoder at
     32 px, batch 2, 200 J batteries, int8 boundary), streamed one host
     sync per revolution, reserve skips by the third revolution, the
     quantizer held bit for bit on the ring's own z and dz, and the host
     engine timed on the first 250 passes of the same ring;
  9. the fleet engine (repro_torch.fleet): (a) two planes of the Table-I
     ring at phase 8a's width for one revolution, with a join, a leave,
     seeded failures, reserve skips and masked steps, against the host
     engine plane by plane (equal actions and slots, losses and batteries
     at 8a's tolerances), every plane's params and momentum equal to the
     hosts' mean after the boundary, one sync for the revolution, 2
     quantizer launches per executed step, with passes/s, steps/s, the
     host engines' time and the idle share; (b) the baseline smoke of
     ``python -m repro_torch.fleet`` (2 planes x 8 satellites, 2
     revolutions) on the card;
 10. the ISL exchange and the degraded-ops fleet (repro_torch.isl,
     repro_torch.fleet.scenarios): (a) phase 9a's two planes under
     eclipses, an epidemic (every plane's pass 0 a fault), a
     sign-flipping Byzantine slot and the async int8 ISL gossip every 4
     passes instead of the free average: actions and every EV_EXCHANGE
     row equal to the NumPy oracles bit for bit, finite losses on the
     honest plane, one sync for the revolution, B1 launches = 2 x
     executed steps + contacts x planes x parameter leaves with no copy,
     one push's codec kernel against its plain version leaf by leaf and
     against the same push on the host, and the codec's largest leaf
     timed against its bound; (b) ``python -m repro_torch.isl`` and
     ``python -m repro_torch.fleet --scenario degraded`` at their
     reference sizes on the card;
 11. the serving fleet (repro_torch.serve_fleet): (a) full-width
     Granite-3.0-2B split at unit 20 through both attention kernels
     (phase 4's checks: exactly 40 B2 launches a prefill and 40 B3 a
     decode step, none of B1, B4 or B5), the reference smoke's
     pass-window traffic (8 windows, prompts from PassWindowTraffic)
     served by its split engine, the measured rate as a ServeCost, and
     the serving fleet on the card at the reference smoke's size (2 x 8,
     24 windows) and at a constellation's (4 x 256, 1,000 windows of the
     pass duration, 10^6 users/day), each held to the NumPy oracle with
     one host sync under sync-debug "error" and one EV_SERVE per (plane,
     window), with host ms a window and the card's share of 100 windows;
     (b) ``python -m repro_torch.serve_fleet``, ``python -m
     repro_torch.obs``, ``python -m repro_torch.obs render --planes 4
     --sats 256 --scenario degraded --serve`` and the paper's tables
     (Fig. 3's claims) with the float64 solver on the card;
 12. LM training (repro_torch.train, repro_torch.launch.train,
     sl_step.lm_adapter): (a) full-width SmolLM-360M through
     ``launch.train`` (batch 8, seq 512, bf16, remat full, AdamW, 20
     steps): finite, falling losses, exactly 64 flash-attention launches a
     step (32 forward, 32 remat recompute) and none of the other kernels,
     one f32 step's loss and gradients on the kernel path against the
     plain path, steps/s, tokens/s and the card's share of the step
     ``launch.train`` runs (its one rank's (1, 1) mesh), timed in turns
     with the mesh-less step; (b)
     SmolLM-360M split at unit 16 through the constellation ring (batch
     4, AdamW, int8 boundary, 4 passes): 2 quantizer and 32 attention
     launches a SL step with no copy, the boundary's bits, one SL step
     kernel path against plain path, SL steps/s; (c) one train step of
     the Zamba2 and xLSTM smoke configs on the card, every projection
     weight's gradient nonzero and equal to the CPU's, then the same for
     the Mixtral and Phi-3.5-MoE smoke configs under both MoE dispatch
     layouts (router and experts nonzero);
 13. the head-dim-128 architectures: (a) Mixtral-8x7B at its published
     widths cut to 16 of its 32 layers (bf16 weights at rest, 46.96 GB),
     split at unit 8, phase 4's checks (16 B2 a prefill, 16 B3 a decode
     step; its decode logits held in f32 activations, its f32 prefill
     logits on 2 units of f32 weights) and its peak device memory; (b)
     Llama-3-8B, InternLM2-20B, Qwen2-VL-7B and Phi-3.5-MoE at their
     published widths, 2 units each (f32 weights), split at unit 1: 8
     prefills and 8 decode steps with every kernel call held to its
     plain version, exact counts, split == unsplit, f32 logits kernel vs
     plain, and Qwen2-VL's 256-patch vision prefix;
 15. the dry run against the card (repro_torch.launch.dryrun and the
     census, repro_torch.utils.census): (a) full-width SmolLM-360M's
     train step (phase 12a's 8 x 512, bf16, remat full, AdamW), a
     498-token prefill and a decode step at 8 slots over a full 2,048-row
     cache, (b) Zamba2-1.2B's prefill and decode step, (c) xLSTM-1.3B's
     64-token prefill, each counted under the census on the card and on
     meta: equal FLOPs, bytes, op counts and kernel launches, the
     census's peak within 10% of the step's max_memory_allocated rise,
     the step's time against the dry run's bound (the roofline fraction
     on this card); (d) the dry run's SmolLM sweep and its roofline
     table;
 16. the train step on a (data, model) mesh (repro_torch.models.parallel,
     launch.mesh): min(cards, 4) ranks, one card each, over NCCL, run
     full-width SmolLM-360M at phase 12a's shape (8 x 512, bf16, remat
     full, AdamW) for 3 steps on make_host_mesh(1), exactly 64 B2
     launches a step on every rank; on one card the (1, 1) mesh equals
     the one-process step bit for bit in loss, grad norm and every
     parameter after each step (on more, the (n, 1) mesh's loss within
     bf16's rounding and its parameters within twice the steps' summed
     learning rate, and one f32 step on the (n, 1) mesh, on
     make_host_mesh(2), and of Llama-3-8B cut to 2 layers with every
     card on the model axis, each within 1e-5 in loss, 5e-4 in
     parameters and 1e-2 in the update's relative l2 error); the mesh,
     collective calls, ms and peak memory a step.
Phase 3 also holds B2's lse and its autograd Function at SmolLM's
training shape (the plain backward timed beside SDPA's forward +
backward), and the scans' Functions at full-width heads (gradients bit
for bit the plain path's).
Each phase prints its elapsed time. Every profile is framed by marker
kernels (cuda_events), since torch.profiler can drop a trace's first
kernels.
Phases 4, 6, 7 and 11a also print the satellite's joules per token at
their measured rate (serve_cost). The last two lines are the kernels' JSON
record and the result JSON.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import sl_step  # noqa: E402
from repro_torch.core import resource_opt  # noqa: E402
from repro_torch.core.constellation import (ConstellationConfig,  # noqa: E402
                                            ConstellationSim)
from repro_torch.core.energy import PassBudget  # noqa: E402
from repro_torch.core.orbits import OrbitalPlane  # noqa: E402
from repro_torch.core.splitting import RESNET18_PAPER_CUTS  # noqa: E402
from repro_torch.core.train_state import SLTrainState, _leaves  # noqa: E402
from repro_torch.data.synthetic import ImageryShards, TokenShards  # noqa: E402
from repro_torch.fleet import (ByzantineConfig, EclipseConfig,  # noqa: E402
                               EpidemicConfig, FleetConfig, FleetEngine,
                               ScenarioConfig, oracle_actions)
from repro_torch.fleet.engine import _smoke as fleet_smoke  # noqa: E402
from repro_torch.fleet.scenarios import (  # noqa: E402
    _smoke_degraded as degraded_smoke)
from repro_torch.isl import (CodecConfig, ContactConfig,  # noqa: E402
                             ExchangeConfig, encode_delta, exchange_events,
                             oracle_exchange)
from repro_torch.isl.__main__ import _smoke as isl_smoke  # noqa: E402
from repro_torch.kernels import (_build, decode_attn, flash_attn,  # noqa: E402
                                 mamba_scan, mlstm_scan, ops, split_quant)
from repro_torch.kernels.recompute import flat  # noqa: E402
from repro_torch.models import lm, parallel  # noqa: E402
from repro_torch.models.param import ShardingRules  # noqa: E402
from repro_torch.models.param import init_params, map_tree  # noqa: E402
from repro_torch.obs.ring import EV_EXCHANGE, EV_SERVE  # noqa: E402
from repro_torch.train.optimizer import resolve_optimizer  # noqa: E402
from repro_torch.utils.bucketing import bucket_size  # noqa: E402
from repro_torch.utils.census import Census  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.utils.treeutil import (tree_flatten_with_names,  # noqa: E402
                                       tree_leaves)
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.serve.engine import (DecodeEngine, Request,  # noqa: E402
                                      _cast_matmul_weights)
from repro_torch.serve_fleet import __main__ as serve_fleet_main  # noqa: E402
from repro_torch.serve_fleet.__main__ import (  # noqa: E402
    SMOKE_TRAFFIC, SMOKE_TRAIN, serve_windows)
from repro_torch.serve_fleet.__main__ import (  # noqa: E402
    smoke_fleet as serve_fleet_smoke_fleet)
from repro_torch.serve_fleet.engine import (  # noqa: E402
    FleetServeEngine, ServeFleetConfig, SplitDecodeEngine, TrainLoad,
    assert_host_parity, serve_cost)
from repro_torch.serve_fleet.traffic import (PassWindowTraffic,  # noqa: E402
                                             TrafficConfig)
from repro_torch.launch import dryrun, paper_tables  # noqa: E402
from repro_torch.launch import mesh as h100  # noqa: E402
from repro_torch.launch import roofline as roofline_report  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch import (constellation_online_learning,  # noqa: E402
                                isl_exchange, quickstart, serve_batched)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,  # noqa: E402
                                         lr_at)
from repro_torch.train.step import (TrainConfig, TrainState,  # noqa: E402
                                    loss_and_grads, make_decode_step,
                                    make_prefill_step, make_train_step)
from repro_torch.obs import __main__ as obs_main  # noqa: E402
from repro_torch.obs.metrics import sync_budget  # noqa: E402
from repro_torch.sim import (ACTION_NAMES, ACTION_SHED,  # noqa: E402
                             ACTION_SKIPPED, ACTION_TRAINED,
                             DeviceConstellationSim, DeviceImageryShards,
                             DeviceSimConfig, plan_ring_passes)
from repro_torch.sim.device_sim import ACTION_FAULT  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = h100.HBM_BW
PEAK_OPS = {torch.bfloat16: h100.PEAK_FLOPS_BF16,
            torch.float32: h100.PEAK_FLOPS_F32}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}    # as the CPU tests
H, KV, D = 15, 5, 64                                 # SmolLM-360M heads
MHA_H = 32                                           # Zamba2-1.2B: H = KV
GRANITE_H, GRANITE_KV = 32, 8                        # Granite-3.0-2B: group 4
GRANITE_PREFILL_S = (5, 512)     # 5: the serving traffic's prompts (11a)
SMOKE_H, SMOKE_D = 4, 16               # the smoke configs' heads (Zamba2's)
# Head dim 128 (phase 13's models): (H, KV) of Llama-3-8B, Mixtral-8x7B and
# Phi-3.5-MoE (group 4), InternLM2-20B (group 6) and Qwen2-VL-7B (group 7;
# B3 serves groups 6 and 7 in its 8-head bucket), at S = 512; Mixtral's
# sliding window at a prompt past it; B2's lse at Mixtral's heads.
D128 = 128
D128_HEADS = [(32, 8), (48, 8), (28, 4)]
D128_S = 512
MIXTRAL_WINDOW_S, MIXTRAL_WINDOW = 6144, 4096
PREFILL_S = (1, 77, 498, 512, 1000)     # 498: the longest served prompt
DECODE_B, DECODE_S = 8, 2048
DECODE_LENS = [1, 2048, 100, 513, 1024, 37, 2000, 777]
# The quantizer's shapes: ResNet-18's l2 boundary at 224 px and batch 8
# (z and dz, 8*28*28 rows of 128 channels) in f32 and bf16, the
# autoencoder's 224-px latent (8*7*7 rows of 3), and a d that is not a
# multiple of the 16-byte vector. Every input has all-zero rows and .5 ties.
QUANT_SHAPES = [(6272, 128, torch.float32), (6272, 128, torch.bfloat16),
                (392, 3, torch.float32), (1000, 130, torch.float32)]
# The same boundaries as the training path hands them over on the card,
# an NHWC view of NCHW memory (channel-major rows): ResNet-18's l2 z and
# dz, the autoencoder latent at 224 px, and at 32 px and batch 2 (phase
# 8b's ring, 12,000 of the main paths' launches; phase 8b also holds the
# kernel against the plain version on its own z and dz).
QUANT_CM_SHAPES = [((8, 28, 28, 128), torch.float32),
                   ((8, 28, 28, 128), torch.bfloat16),
                   ((8, 7, 7, 3), torch.float32),
                   ((2, 1, 1, 3), torch.float32)]
# SmolLM-360M's split-ring boundary (phase 12b): z and dz of batch 4 x
# seq 512 at d 960, f32, row-major (B1's two launches a SL step; phase
# 12b also holds the kernel against the plain version on its own z, dz).
LM_BOUNDARY_SHAPES = [((4, 512, 960), torch.float32)]
# The Mamba-2 scan at Zamba2-1.2B's full-width heads (H=64, P=N=64,
# chunk 128): (B, S), S = 1 and ragged last chunks included.
MAMBA_H, MAMBA_P, MAMBA_N, MAMBA_CHUNK = 64, 64, 64, 128
MAMBA_SHAPES = [(1, 1), (1, 100), (1, 512), (1, 1000), (2, 257)]
# f32: the reference's scan tolerance (MAMBA_SWEEP, tests/test_kernels.py);
# bf16: y rounds to bf16 after f32 sums taken in another order than the
# plain version's (1 ulp = 2**-8 relative), as the attention kernels.
MAMBA_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-4}
# The mLSTM scan at xLSTM-1.3B's full-width heads (H=4, P=1024; the
# model's chunk 256, of which the kernel takes 64): (B, S) as for Mamba-2.
MLSTM_H, MLSTM_P, MLSTM_CHUNK = 4, 1024, 256
MLSTM_SHAPES = MAMBA_SHAPES
# h: f32 at the reference's mLSTM tolerance (tests/test_kernels.py), bf16
# as the Mamba-2 scan's y (1 ulp after f32 sums in another order); the
# f32 state C, n, m at the reference's tolerance in both.
MLSTM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MLSTM_STATE_TOL = 1e-4
# The training ring (phase 5): Table I's 25-satellite plane and its 400
# items per pass, capped at 8 SL steps a pass so the phase stays short.
RING_PASSES, RING_STEPS, RING_BATCH = 6, 8, 8
L2_INT8_BITS_PER_ITEM = 28 * 28 * 128 * 8          # 802,816
# Table II's l2 D_tx at f32, 3.211e6 bits (benchmarks/paper_tables.py:29),
# exactly 28*28*128*32
L2_F32_DTX_BITS = 3_211_264
# One SL step's loss, kernel path vs plain-quantizer path: the kernel is
# bit-exact, so the two differ only by cuDNN's run-to-run order of sums.
STEP_LOSS_RTOL = 1e-5
# One decode step's logits, kernel path vs plain path, both in bf16
# activations: the attention outputs round to bf16 at different sums, and
# the 1-ulp differences travel through 32 layers. Held to 3% of the
# largest logit (PERF.md, "Findings").
LOGITS_TOL_OF_MAX = 0.03
# A whole prefill's logits, kernel path vs plain path, in f32 activations:
# bf16 ones are not comparable, since Zamba2's 1-ulp differences per call
# grow along the sequence and through 36 blocks to ~25% of the largest
# logit (PERF.md, Findings), so the bf16 prefill is held call by call
# instead. In f32 the two paths agreed to 9e-5 of the largest logit on
# the card (PERF.md, Findings); held to 1e-3 of it. xLSTM-1.3B's 48 blocks
# amplify the order of f32 sums ~1000-fold: two plain paths that differ
# only in the mLSTM chunk (64 against 256, both exact) part by 1.3% of
# the largest logit (PERF.md, Findings). There the kernel path is held to
# the plain path at the kernel's chunk within that spread, measured anew.
PREFILL_F32_TOL_OF_MAX = 1e-3
# Marker kernels on each side of a profiled region (cuda_events): runs on
# the H100 lost 1-4 of a trace's first kernels.
PROFILE_EDGE = 4
# Phase 3's training rows: B2 at SmolLM-360M's training shape (phase 12a:
# batch 8, seq 512), its lse at the attention tolerance of its dtype and
# the gradients of its autograd Function against the plain path's at the
# reference's gradient tolerance (bf16: the attention tolerance, as the
# outputs the backward starts from differ by an ulp); the scans'
# Functions at Zamba2's and xLSTM's full-width heads, whose gradients
# must equal the plain path's bit for bit (the backward is the plain
# scan's, re-run on the same inputs).
TRAIN_B, TRAIN_S = 8, 512
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-4}
SCAN_GRAD_S = 512
# Phase 12: full-width SmolLM-360M trained through ``launch.train`` (12a)
# and split through the constellation ring (12b, the reference's
# test_constellation_lm_adapter_adamw at full width), and one train step of
# the Zamba2 and xLSTM smoke configs on the card against the CPU (12c).
LM_TRAIN_STEPS = 20
LM_B2_PER_STEP = 64                 # 32 layers, forward and remat recompute
LM_RING_PASSES, LM_RING_STEPS, LM_RING_BATCH, LM_CUT = 4, 4, 4, 16
LM_B2_PER_SL_STEP = 32              # 16 layers a segment, forward only
LM_STEP_LOSS_RTOL = 1e-5
LM_TIMED = 3                        # 12a: steps a timed round
# Phase 14: Whisper-small at its published widths (12 + 12 layers, d 768,
# 12 MHA heads of 64, d_ff 3,072, vocab 51,865, 1,500 encoder frames).
# 14a serves 8 requests of 1,500 seeded stub frames and 64-token prompts
# through make_prefill_step, then cache_from_prefill at s_max 448
# (openai/whisper-small's max_target_positions) and 32 greedy steps of
# make_decode_step: B2 runs 3 a layer a prefill (encoder, self, cross),
# B3 2 a layer a step (self, cross over the fixed memory). 14b trains it
# through launch.train (batch 4 x 128, bf16, remat full, AdamW): 12
# encoder B2, 24 decoder and 24 recomputed a step. Phase 3 holds B2 and B3
# at these shapes.
WHISPER_H, WHISPER_FRAMES = 12, 1500
WHISPER_B, WHISPER_PROMPT, WHISPER_S_MAX = 8, 64, 448
WHISPER_STEPS, WHISPER_PARITY_STEPS = 32, 8
WHISPER_B2_PER_PREFILL, WHISPER_B3_PER_STEP = 36, 24
WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 4, 128, 10
WHISPER_B2_PER_TRAIN_STEP = 60
# prefill-then-decode against the full forward (f32, kernel path), the
# tolerance of tests/test_decode_parity.py::test_prefill_then_decode
DECODE_PARITY_TOL = 2e-3
# Phase 15: the dry run (repro_torch.launch.dryrun, on meta) against the
# same step counted on the card: SmolLM-360M's train step at phase 12a's
# shape, a 498-token prefill and a decode step at phase 4's 8 slots over
# a full 2,048-row cache (the dry run counts a decode cell's cache full);
# Zamba2-1.2B's prefill and decode step; xLSTM-1.3B's 64-token prefill.
# Census peak against the step's max_memory_allocated rise within 10%.
P15_PREFILL_S, P15_XLSTM_S = 498, 64
P15_PEAK_TOL = 0.10
P15_TIMED = {"train": 3, "prefill": 5, "decode": 10}
# Phase 16: ranks of the sharded train step (one card each, at most 4),
# each a process of this script (``--mesh-rank``), at phase 12a's shape.
P16_STEPS, P16_TIMEOUT_S = 3, 600
P16_ADAMW = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=P16_STEPS)
P16_BF16_LOSS_RTOL = 2.0 ** -9     # a data axis sums bf16 partial grads
# an AdamW step moves an element by at most ~lr (|m_hat / sqrt(v_hat)|
# <= 1.001 in the first steps), so two runs' params part by at most
# twice the sum of the steps' lr where rounding flips a sign
P16_BF16_PARAM_SLACK = 2 * 1.001
# f32 steps: loss, params, and the update's relative l2 error against one
# process's (a data rank's slice updated wrongly or not gathered moves it
# by >= sqrt(1/4) on up to 4 ranks)
P16_F32 = dict(loss_rtol=1e-5, atol=5e-4, rtol=5e-4, update_rel=1e-2)
# With 2+ cards: Llama-3-8B at published widths, reduced: n_layers 32 -> 2,
# batch 2 x 512, f32, one step with every card on the model axis
P16_LLAMA_LAYERS, P16_LLAMA_B = 2, 2


def check(ok, what):
    """A failed check ends the run (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, iters=20, flush=None):
    """Median device time of ``fn`` by CUDA events, one launch per pair of
    events; ``flush`` (a large buffer) is rewritten before each launch so
    the launch finds the 50 MB L2 cold, as a decode layer does."""
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound(nbytes, nops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_prefill(dtype, S, gen, flush, H=H, KV=KV, D=D, window=None,
                  B=1, Skv=None, causal=True):
    """B2 at (B, H, S, D) against (B, KV, Skv, D) keys (Skv = S unless
    given), causal (with a window) or not."""
    dev = torch.device("cuda")
    Skv = S if Skv is None else Skv
    q, k, v = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, H, S, D), (B, KV, Skv, D), (B, KV, Skv, D))]
    got = flash_attn.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window)
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    del want
    kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    b_ms, b_by = bound(*flash_attn.work(q, k, causal=causal, window=window),
                       dtype)
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                      is_causal=causal)
    else:
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - window)
        sdpa = lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                      attn_mask=band)
    return dict(
        shape=f"prefill B={B} H={H} KV={KV} S={S} D={D}"
              + ("" if Skv == S else f" Skv={Skv}")
              + ("" if causal else " non-causal")
              + ("" if window is None else f" window={window}")
              + f" {str(dtype)[6:]}",
        max_abs_err=err,
        ms=time_ms(lambda: flash_attn.flash_attention_fwd(
            q, k, v, causal=causal, window=window), flush=flush),
        plain_ms=time_ms(lambda: flash_attn.flash_attention_plain(
            q, k, v, causal=causal, window=window), flush=flush),
        library_ms=time_ms(sdpa, flush=flush),
        bound_ms=b_ms, bound_by=b_by)


def check_decode(dtype, gen, flush, H=H, KV=KV, D=D, S=DECODE_S,
                 lens=DECODE_LENS):
    """B3 for DECODE_B rows of one token against (DECODE_B, KV, S, D)
    caches, row b valid up to lens[b]."""
    dev = torch.device("cuda")
    q, k, v = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((DECODE_B, H, 1, D), (DECODE_B, KV, S, D),
                         (DECODE_B, KV, S, D))]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attn.decode_attention(q, k, v, lengths)
    again = decode_attn.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"decode {dtype} H={H} D={D}: two runs "
          f"differ (the split merge must be deterministic)")
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    b_ms, b_by = bound(*decode_attn.work(q, k, sum(lens)), dtype)
    return dict(
        shape=f"decode B={DECODE_B} H={H} KV={KV} s_max={S} D={D} "
              f"lengths={lens} {str(dtype)[6:]}", max_abs_err=err,
        splits=decode_attn.n_splits(S, D, dtype),
        split_rows=decode_attn.split_rows(D, dtype),
        ms=time_ms(lambda: decode_attn.decode_attention(q, k, v, lengths),
                   flush=flush),
        plain_ms=time_ms(lambda: decode_attn.decode_attention_plain(
            q, k, v, lengths), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask), flush=flush),
        bound_ms=b_ms, bound_by=b_by)


def quant_input(rows, d, dtype, gen):
    x = torch.randn((rows, d), generator=gen, device="cuda") * 7.3
    x[::7] = 0.0                                   # all-zero rows
    ties = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5][:d]
    x[1, :len(ties)] = torch.tensor(ties, device="cuda")   # scale 1: .5 ties
    return x.to(dtype)


def quant_cases(gen):
    """(label, x) for phase 3: QUANT_SHAPES as row-major rows, then
    QUANT_CM_SHAPES as channel-major rows (the NHWC view of NCHW memory),
    then LM_BOUNDARY_SHAPES as row-major (B, S, d) tensors."""
    for rows, d, dtype in QUANT_SHAPES:
        yield (f"rows={rows} d={d} {str(dtype)[6:]} row-major",
               quant_input(rows, d, dtype, gen))
    for (N, H, W, C), dtype in QUANT_CM_SHAPES:
        x = quant_input(N * H * W, C, dtype, gen).reshape(N, H, W, C)
        yield (f"{(N, H, W, C)} {str(dtype)[6:]} channel-major",
               x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    for shape, dtype in LM_BOUNDARY_SHAPES:
        yield (f"{shape} {str(dtype)[6:]} row-major",
               quant_input(int(np.prod(shape[:-1])), shape[-1], dtype,
                           gen).reshape(shape))


def check_quant(label, x, fused, flush):
    """One quantizer entry against its plain version, bit for bit, with no
    copy of x: the fused quantize-dequantize (xhat in x's strides) or the
    codes and scales. Timed by event pairs and by device time per kernel,
    beside the device time of a ``copy_`` of x into x's layout (x read
    and written once: a practical floor, not a library call)."""
    entry = (split_quant.quantize_dequantize if fused
             else split_quant.quantize_rows)
    plain = (split_quant.quantize_dequantize_plain if fused
             else split_quant.quantize_rows_plain)
    c0 = split_quant.copies
    got, want = flat(entry(x)), flat(plain(x))
    torch.cuda.synchronize()
    what = f"quantizer {entry.__name__} {label}"
    check(split_quant.copies == c0, f"{what}: x was copied")
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{what}: not bit-identical to plain")
    check(not fused or got[0].stride() == x.stride(),
          f"{what}: xhat strides {got[0].stride()} != x's {x.stride()}")
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    b_ms, b_by = bound(*split_quant.work(x, fused), torch.float32)
    dst = torch.empty_like(x)
    return dict(
        shape=f"{entry.__name__} {label}", max_abs_err=err,
        ms=time_ms(lambda: entry(x), flush=flush),
        plain_ms=time_ms(lambda: plain(x), flush=flush),
        device=device_ms(lambda: entry(x), flush),
        copy_ms=sum(ms for *_, ms in device_ms(lambda: dst.copy_(x), flush)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_mamba(dtype, B, S, gen, flush):
    """The SSD scan kernel against its plain version at Zamba2's heads; in
    bf16 its three launches are timed by name (``stages``)."""
    dev = torch.device("cuda")
    Hm, P, N = MAMBA_H, MAMBA_P, MAMBA_N
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = rnd(B, S, Hm, P).to(dtype)
    dt = F.softplus(rnd(B, S, Hm))
    a_log = rnd(Hm) * 0.5
    b, c = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype)
    args = (x, dt, a_log, b, c)
    y, h = mamba_scan.mamba_chunk_scan(*args, chunk=MAMBA_CHUNK)
    yp, hp = mamba_scan.mamba_chunk_scan_plain(*args, chunk=MAMBA_CHUNK)
    torch.cuda.synchronize()
    tol = MAMBA_TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hp, atol=tol, rtol=tol)
    err = max((y.float() - yp.float()).abs().max().item(),
              (h - hp).abs().max().item())
    nbytes, nops = mamba_scan.work(*args, chunk=MAMBA_CHUNK)
    b_ms, b_by = bound(nbytes, nops, dtype)
    run = lambda: mamba_scan.mamba_chunk_scan(*args, chunk=MAMBA_CHUNK)
    return dict(
        shape=f"scan B={B} S={S} H={Hm} P={P} N={N} chunk {MAMBA_CHUNK} "
              f"{str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(run, flush=flush),
        plain_ms=time_ms(lambda: mamba_scan.mamba_chunk_scan_plain(
            *args, chunk=MAMBA_CHUNK), flush=flush),
        stages=device_ms(run, flush) if dtype == torch.bfloat16 else None,
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, ops=nops)


def check_mlstm(dtype, B, S, gen, flush):
    """The mLSTM scan kernel against its plain version at xLSTM's heads:
    h, C, n and m held to the plain version at the kernel's own chunk
    (as phase 7's per-call checks), and timed against the plain version
    at the model's chunk (256). The two plain chunkings are the same
    function, but their f32 sums part by their own rounding (``spread``),
    at S=1000 in f32 by more than the tolerance (PERF.md, PR 17). In bf16
    the kernel's three launches are timed by name (``stages``)."""
    dev = torch.device("cuda")
    Hx, P = MLSTM_H, MLSTM_P
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, k, v = (rnd(B, S, Hx, P).to(dtype) for _ in range(3))
    i_pre, f_pre = rnd(B, S, Hx), rnd(B, S, Hx) + 1.0   # as the reference's test
    args = (q, k, v, i_pre, f_pre)
    L = min(mlstm_scan.L_MAX, S)                        # the kernel's chunk
    h, (C, n, m) = mlstm_scan.mlstm_chunk_scan(*args, chunk=MLSTM_CHUNK)
    hp, (Cp, np_, mp) = mlstm_scan.mlstm_chunk_scan_plain(*args, chunk=L)
    hq, _ = mlstm_scan.mlstm_chunk_scan_plain(*args, chunk=MLSTM_CHUNK)
    torch.cuda.synchronize()
    tol = MLSTM_TOL[dtype]
    torch.testing.assert_close(h.float(), hp.float(), atol=tol, rtol=tol)
    for got, want in ((C, Cp), (n[..., 0], np_), (m, mp)):
        torch.testing.assert_close(got, want, atol=MLSTM_STATE_TOL,
                                   rtol=MLSTM_STATE_TOL)
    err = max((a.float() - b.float()).abs().max().item() for a, b in (
        (h, hp), (C, Cp), (n[..., 0], np_), (m, mp)))
    nbytes, nops = mlstm_scan.work(*args, chunk=MLSTM_CHUNK)
    b_ms, b_by = bound(nbytes, nops, dtype)
    run = lambda: mlstm_scan.mlstm_chunk_scan(*args, chunk=MLSTM_CHUNK)
    return dict(
        shape=f"mlstm B={B} S={S} H={Hx} P={P} chunk {L} "
              f"{str(dtype)[6:]}", max_abs_err=err,
        spread=(hq.float() - hp.float()).abs().max().item(),
        ms=time_ms(run, flush=flush),
        plain_ms=time_ms(lambda: mlstm_scan.mlstm_chunk_scan_plain(
            *args, chunk=MLSTM_CHUNK), flush=flush),
        stages=device_ms(run, flush) if dtype == torch.bfloat16 else None,
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, ops=nops)


# The served models (phases 4, 6 and 7): published widths, seeded random
# weights, the cut, and each kernel's launches per prompt (bulk prefill)
# and per decode step: SmolLM-360M's 32 attention layers; Zamba2-1.2B's 6
# units of 5 Mamba-2 blocks and one pass through the shared block;
# xLSTM-1.3B's 6 units of 7 mLSTM blocks and one sLSTM block (no kernel:
# the mLSTM decode update and the sLSTM recurrence are plain PyTorch).
SERVED = {
    "smollm_360m": dict(dims=(32, 960, 49152), cut=16,
                        per_prompt={"flash_attn_fwd": 32},
                        per_step={"decode_attn": 32}),
    "zamba2_1_2b": dict(dims=(36, 2048, 32000), cut=3,
                        per_prompt={"mamba_scan": 30, "flash_attn_fwd": 6},
                        per_step={"decode_attn": 6}),
}
# Its prefill profile takes one prefill, not three: a 498-token prefill
# is ~20,900 kernels (the sLSTM loop), and three of them (with retakes)
# took phase 7 to 270 s on a slow host.
SERVED["xlstm_1_3b"] = dict(dims=(48, 2048, 50304), cut=3,
                            per_prompt={"mlstm_scan": 42}, per_step={},
                            profiled_prefills=1)
# Phase 11a: Granite-3.0-2B (the serving fleet's model, as the reference
# smoke serves it), 40 attention layers, split at n_units // 2 = 20.
SERVED["granite_3_2b"] = dict(dims=(40, 2048, 49155), cut=20,
                              per_prompt={"flash_attn_fwd": 40},
                              per_step={"decode_attn": 40})
# Phase 13a: Mixtral-8x7B at its published widths (d 4,096, 32/8 heads of
# 128, d_ff 14,336, 8 experts top-2, window 4,096, vocab 32,000), cut in
# depth: 32 layers are 46.70 B parameters, 93.4 GB in bf16, past the
# card's 80 GB; 16 layers are 23.48 B, 46.96 GB. A model cut in depth
# (``published_layers``) has its weights built unit by unit into one
# bf16 copy at rest (init_bf16_at_rest) and takes its f32 logits check
# on F32_UNITS units of the same widths (Mixtral: 12.7 GB in f32).
SERVED["mixtral_8x7b"] = dict(dims=(16, 4096, 32000), cut=8,
                              published_layers=32,
                              per_prompt={"flash_attn_fwd": 16},
                              per_step={"decode_attn": 16})
F32_UNITS = 2
# Phase 13b: the other four models of head dim 128 at their published
# widths, 2 units each (f32 weights), split at unit 1: (d, vocab, group).
TWO_UNIT = {"llama3_8b": (4096, 128256, 4), "internlm2_20b": (6144, 92544, 6),
            "qwen2_vl_7b": (3584, 152064, 7), "phi35_moe": (4096, 32064, 4)}
TWO_UNIT_REQUESTS, TWO_UNIT_STEPS = 8, 8   # 8 prefills, then 8 decode steps
QWEN_PREFIX_S = 320                        # 256 vision patches + 64 tokens
# The served engines' slots, cache length and activations.
SERVE_KW = dict(n_slots=8, s_max=2048, act_dtype=torch.bfloat16,
                device="cuda")
WRAPPERS = {"flash_attn_fwd": flash_attn.flash_attention_fwd,
            "decode_attn": decode_attn.decode_attention,
            "mamba_scan": mamba_scan.mamba_chunk_scan,
            "mlstm_scan": mlstm_scan.mlstm_chunk_scan,
            "split_quant": split_quant.quantize_dequantize}
# What ``ops`` dispatches to on the card, and the plain version that
# replaces it for the comparisons (their launches are not counted).
PLAIN_OPS = {
    "flash_attention": flash_attn.flash_attention_plain,
    "decode_attention": decode_attn.decode_attention_plain,
    "mamba_scan": mamba_scan.mamba_chunk_scan_plain,
    "mlstm_scan": lambda *a, chunk=256: mlstm_scan.mlstm_chunk_scan_plain(
        *a, chunk=min(chunk, mlstm_scan.L_MAX)),    # the kernel's chunk
}
# The ``ops`` name of each serving kernel, and the tolerance of its
# outputs by dtype (phase 3's); f32 outputs of a bf16 call (the scans'
# states) are held at the f32 tolerance.
OP_OF = {"flash_attn_fwd": "flash_attention",
         "decode_attn": "decode_attention",
         "mamba_scan": "mamba_scan", "mlstm_scan": "mlstm_scan"}
OP_TOL = {"flash_attention": TOL, "decode_attention": TOL,
          "mamba_scan": MAMBA_TOL, "mlstm_scan": MLSTM_TOL}


def with_ops(make, fn):
    """``fn()`` with each kernel op of the serving path (the names in
    PLAIN_OPS) replaced by ``make(name, kernel op, plain version)``."""
    kernel_ops = {name: getattr(ops, name) for name in PLAIN_OPS}
    for name, plain in PLAIN_OPS.items():
        setattr(ops, name, make(name, kernel_ops[name], plain))
    try:
        return fn()
    finally:
        for name, op in kernel_ops.items():
            setattr(ops, name, op)


def with_plain_ops(fn):
    """``fn()`` with every kernel op swapped for its plain version."""
    return with_ops(lambda name, kernel_op, plain: plain, fn)


def with_checked_ops(fn):
    """``fn()`` with every kernel op of the serving path run twice on the
    same inputs, as the kernel and as its plain version, each output held
    to the plain one at phase 3's tolerance of its dtype. Returns
    (fn's result, {op: (calls, largest error, largest |plain value|)})."""
    seen = {}

    def checked(name, kernel_op, plain):
        def op(*a, **kw):
            out = kernel_op(*a, **kw)
            got, want = flat(out), flat(plain(*a, **kw))
            check(len(got) == len(want), f"{name}: outputs differ in number")
            for g, w in zip(got, want):
                tol = OP_TOL[name][g.dtype]
                torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                           rtol=tol)
                n, err, top = seen.get(name, (0, 0.0, 0.0))
                seen[name] = (n, max(err, (g.float() - w.float()).abs()
                                     .max().item()),
                              max(top, w.float().abs().max().item()))
            n, err, top = seen[name]
            seen[name] = (n + 1, err, top)
            return out
        return op

    return with_ops(checked, fn), seen


def logits_close(lk, lp, what, tol_of_max=LOGITS_TOL_OF_MAX):
    """Kernel-path logits against plain-path logits: finite f32, within
    ``tol_of_max`` of the largest logit. Returns (err, max, argmax
    agreement)."""
    check(lk.dtype == torch.float32 and bool(torch.isfinite(lk).all()),
          f"finite f32 {what} logits")
    err = (lk - lp).abs().max().item()
    top = lp.abs().max().item()
    check(err <= tol_of_max * top, (what, err, top))
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    return err, top, agree


def init_bf16_at_rest(cfg, gen):
    """Seeded random weights of ``cfg`` in one bf16 copy at rest (the
    leaves the engines keep in f32, ``F32_LEAVES``, in f32), drawn unit
    by unit: ``lm.init`` draws every leaf in f32 at once, which for
    Mixtral at 16 layers is 93.9 GB. The engines' cast to bf16 then keeps
    these tensors as they are, so every engine shares them."""
    tree = lm.abstract_params(cfg)
    cast = lambda t: _cast_matmul_weights(t, torch.bfloat16, "cuda")
    params = cast(init_params({k: v for k, v in tree.items()
                               if k != "units"}, gen))
    unit_spec = map_tree(lambda sp: dataclasses.replace(
        sp, shape=sp.shape[1:], axes=sp.axes[1:],
        view=None if sp.view is None else sp.view[1:]), tree["units"])
    units = None
    for u in range(cfg.n_units):
        one = cast(init_params(unit_spec, gen))
        if units is None:
            units = map_tree(lambda t: t.new_empty((cfg.n_units,) + t.shape),
                             one)
        for (_, dst), (_, src) in zip(tree_flatten_with_names(units),
                                      tree_flatten_with_names(one)):
            dst[u].copy_(src)
        del one
    params["units"] = units
    return params


def serve_full_width(arch, label):
    """Phases 4, 6, 7, 11a's first half and 13a: the served model at full
    width (13a: published widths, cut in depth, bf16 weights at rest).
    Returns (the kernels' launches on the served run, the split engine,
    the weights)."""
    spec = SERVED[arch]
    cfg = configs.get(arch)
    if "published_layers" in spec:
        check(cfg.n_layers == spec["published_layers"],
              f"published {arch} depth")
        cfg = dataclasses.replace(cfg, n_layers=spec["dims"][0])
        print(f"  reduced: n_layers {spec['published_layers']} → "
              f"{cfg.n_layers} ({cfg.param_count() / 1e9:.2f} B parameters, "
              f"{2 * cfg.param_count() / 1e9:.2f} GB in bf16) [{label}]")
    check((cfg.n_layers, cfg.d_model, cfg.vocab) == spec["dims"],
          f"full-width {arch} config")
    cut = spec["cut"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cut_in_depth = "published_layers" in spec
    params = init_bf16_at_rest(cfg, gen) if cut_in_depth else \
        lm.init(cfg, gen)
    split = SplitDecodeEngine(cfg, params, cut_units=cut, **SERVE_KW)
    rng = np.random.default_rng(0)
    plens = rng.integers(32, 513, 16)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in plens]
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]

    # warm-up on a throwaway engine (cuBLAS handles, allocator)
    SplitDecodeEngine(cfg, params, cut_units=cut, **SERVE_KW).submit_and_run(
        reqs()[:2])

    prefill_ms, step_ms = [], []
    step_launches = dict.fromkeys(WRAPPERS, 0)   # launched in decode steps

    def timed(fn, out, launched=None):
        def wrapper(*a):
            n0 = {k: w.launches for k, w in WRAPPERS.items()}
            t0 = time.perf_counter()
            r = fn(*a)                      # returns host values: synced
            out.append((time.perf_counter() - t0) * 1e3)
            if launched is not None:
                for k, w in WRAPPERS.items():
                    launched[k] += w.launches - n0[k]
            return r
        return wrapper

    split._prefill = timed(split._prefill, prefill_ms)
    split._step = timed(split._step, step_ms, step_launches)
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = split.submit_and_run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # every kernel's count: those the model does not run launched 0 times
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    want = {**dict.fromkeys(WRAPPERS, 0),
            **{n: k * len(prefill_ms) for n, k in spec["per_prompt"].items()},
            **{n: k * len(step_ms) for n, k in spec["per_step"].items()}}
    check(len(prefill_ms) == 16 and launches == want,
          f"launches {launches} != {want} ({len(prefill_ms)} prompts, "
          f"{len(step_ms)} decode steps)")
    want_step = {k: spec["per_step"].get(k, 0) * len(step_ms)
                 for k in WRAPPERS}
    check(step_launches == want_step,
          f"decode-step launches {step_launches} != {want_step}")

    check(sorted(out) == list(range(16)), "every request served")
    check(all(len(t) == 32 and all(0 <= x < cfg.vocab for x in t)
              for t in out.values()), "32 in-vocabulary tokens per request")
    unsplit = DecodeEngine(cfg, params, **SERVE_KW).submit_and_run(reqs())
    check(unsplit == out, "split and unsplit greedy tokens differ")

    # one decode step's f32 logits: kernel path vs plain path, same state,
    # in bf16 activations; an MoE model runs that step
    # with every kernel call held to its plain version and its logits
    # printed, and holds the logits of the same step in f32 activations:
    # in bf16 a 1-ulp difference can flip a token's top-k expert or push
    # another token past an expert's capacity, a discrete change of that
    # row (PERF.md, Findings)
    tokens = torch.tensor(split.last_tok[:, None], device="cuda")
    positions = torch.tensor(np.minimum(plens[:8] + 3, 2047), device="cuda")
    ctx = Ctx(cfg=cfg, mode="decode", act_dtype=torch.bfloat16)
    cache0 = map_tree(torch.clone, split.cache)
    moe_decode = ""
    with torch.no_grad():
        if cfg.n_experts:
            c32 = [map_tree(lambda t: t.float(), cache0) for _ in range(2)]
        step = lambda c, dt: lm.decode_step_split(
            cfg, split.params_sat, split.params_gnd, c, tokens, positions,
            ctx=dataclasses.replace(ctx, act_dtype=dt))
        if cfg.n_experts:
            (lk, _, _), dcalls = with_checked_ops(
                lambda: step(split.cache, torch.bfloat16))
        else:
            lk, _, _ = step(split.cache, torch.bfloat16)
        lp, _, _ = with_plain_ops(lambda: step(cache0, torch.bfloat16))
        if cfg.n_experts:
            lk32, _, _ = step(c32[0], torch.float32)
            lp32, _, _ = with_plain_ops(lambda: step(c32[1], torch.float32))
            del c32
    del cache0
    if cfg.n_experts:
        check({n: c[0] for n, c in dcalls.items()}
              == {OP_OF[k]: n for k, n in spec["per_step"].items()},
              f"checked decode calls {dcalls}")
        row_err = (lk - lp).abs().amax(dim=(1, 2))
        b_agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        d_err, d_max, d_agree = logits_close(lk32, lp32, "f32 decode")
        moe_decode = (
            f"; the same step in bf16 activations: every call vs plain "
            f"(calls, err, max |plain|) " + ", ".join(
                f"{n} {c}x ({e:.3e}, {t:.3e})" for n, (c, e, t) in
                dcalls.items())
            + f", logits max abs err by row "
            f"{[round(e, 4) for e in row_err.tolist()]} (not held: top-k "
            f"routing flips), argmax equal in {b_agree:.0%} of 8 rows")
    else:
        d_err, d_max, d_agree = logits_close(lk, lp, "decode")

    # one prefill (the longest prompt): in bf16 every kernel call against
    # its plain version on the same inputs, and the logits of both paths
    # (printed); in f32 activations the logits of both paths, held
    longest = torch.tensor(prompts[int(np.argmax(plens))][None, :],
                           device="cuda")
    pctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.bfloat16)
    # f32 weights for the f32 logits: the model's own, or (cut in depth)
    # f32 weights of F32_UNITS units at the same widths
    cfg32, params32 = cfg, params
    if cut_in_depth:
        cfg32 = dataclasses.replace(
            cfg, n_layers=F32_UNITS * len(cfg.pattern_unit()))
        params32 = lm.init(cfg32, torch.Generator(device="cuda")
                           .manual_seed(1))
    pctx32 = Ctx(cfg=cfg32, mode="prefill", act_dtype=torch.float32)
    with torch.no_grad():
        (pk, _, _), calls = with_checked_ops(lambda: lm.forward(
            cfg, split.params, longest, ctx=pctx))
        pp, _, _ = with_plain_ops(lambda: lm.forward(
            cfg, split.params, longest, ctx=pctx))
        pk32, _, _ = lm.forward(cfg32, params32, longest, ctx=pctx32)
        pp32, _, _ = with_plain_ops(lambda: lm.forward(
            cfg32, params32, longest, ctx=pctx32))
        spread = 0.0
        if "mlstm_scan" in spec["per_prompt"]:
            # the plain path at the model's chunk against the plain path
            # at the kernel's: the spread of two exact chunkings
            pq32, _, _ = with_ops(
                lambda name, kernel_op, plain:
                    mlstm_scan.mlstm_chunk_scan_plain
                    if name == "mlstm_scan" else plain,
                lambda: lm.forward(cfg, params, longest, ctx=pctx32))
            spread = (pq32 - pp32).abs().max().item()
    del params32
    want_calls = {OP_OF[k]: n for k, n in spec["per_prompt"].items()}
    check({n: c[0] for n, c in calls.items()} == want_calls,
          f"checked prefill calls {calls}")
    check(bool(torch.isfinite(pk).all()), "finite bf16 prefill logits")
    b_err = (pk - pp).abs().max().item()
    b_agree = (pk.argmax(-1) == pp.argmax(-1)).float().mean().item()
    p_tol = max(PREFILL_F32_TOL_OF_MAX,
                spread / pp32.abs().max().item())
    p_err, p_max, p_agree = logits_close(pk32, pp32, "f32 prefill", p_tol)

    n_tok = sum(len(t) for t in out.values())
    # the satellite's joules per token at the measured rate, Table-I link
    # and device (PassBudget() defaults), the bf16 boundary's bits
    cost = serve_cost(cfg, params, cut, tokens_per_s=n_tok / wall,
                      act_bits=split.act_dtype.itemsize * 8)
    check(cost.e_token_j > 0 and cost.dtx_bits_token
          == split.boundary_bits_per_token, f"serve cost {cost}")
    print(f"serve {arch} split@{cut}, 8 slots, s_max 2048, 16 requests "
          f"(prompts {plens.min()}-{plens.max()}), 32 new tokens each [{label}]")
    print(f"  {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s "
          f"[{label}]")
    print(f"  serve_cost at {cost.tokens_per_s:.1f} tok/s: e_token_j "
          f"{cost.e_token_j:.6g} J per token on the satellite (DVFS compute "
          f"of units [0, {cut}) + downlink of {cost.dtx_bits_token:.0f} "
          f"bits), PassBudget() defaults; a 90 s window serves "
          f"{cost.window_capacity_requests(90.0, 32):.0f} requests of 32 "
          f"tokens")
    print(f"  prefill median {statistics.median(prefill_ms):.2f} ms over "
          f"{len(prefill_ms)} prompts [{label}]")
    print(f"  decode step median {statistics.median(step_ms):.2f} ms over "
          f"{len(step_ms)} steps [{label}]")
    print(f"  launches on this run: {launches} = per prompt "
          f"{spec['per_prompt']} and per decode step {spec['per_step']} "
          f"(decode steps launched {step_launches}); split tokens == "
          f"unsplit")
    print(f"  logits kernel vs plain (tol {LOGITS_TOL_OF_MAX:.0%} of max "
          f"|logit|): decode" + (" (f32 activations)" if moe_decode else "")
          + f" max abs err {d_err:.3e} of {d_max:.3e}, argmax "
          f"equal in {d_agree:.0%} of 8 rows{moe_decode}")
    print(f"  prefill of {longest.shape[1]} tokens, kernel vs plain: bf16 "
          f"calls (err, max |plain|) " + ", ".join(
              f"{n} {c}x ({e:.3e}, {t:.3e})" for n, (c, e, t) in
              calls.items()) + f"; bf16 logits max abs err {b_err:.3e} "
          f"(not held: differences grow along the sequence), argmax equal "
          f"in {b_agree:.1%}; f32 logits max abs err {p_err:.3e} of "
          f"{p_max:.3e} (tol {p_tol:.3g} of max; mLSTM chunking spread "
          f"{spread:.3e}), argmax equal in {p_agree:.1%} of positions"
          + (f"; f32 logits on {cfg32.n_layers} layers of f32 weights at "
             f"the same widths" if cfg32 is not cfg else ""))
    profile_decode(split, label)
    profile_calls(lambda: split._prefill(prompts[int(np.argmax(plens))]),
                  spec.get("profiled_prefills", 3),
                  f"prefills of {longest.shape[1]} tokens", label)
    return launches, split, params


def cuda_events(run, whole=None, retake=True):
    """The kernels (CUDA events by name) of torch.profiler's trace of
    ``run()``. The profiler has lost the first kernels of a trace on the
    H100 (all of a trace's quantizer launches once, 1 of 20 another time,
    in phase 5; 3 marker kernels at one edge of every CPU+CUDA trace), so
    the trace is framed by ``PROFILE_EDGE`` marker kernels on each side
    (``torch.cuda._sleep``'s ``spin_kernel``, left out of the result),
    which a loss at an edge takes first. The trace is kernel-only (the
    callers read only the kernels; a CPU+CUDA trace of a revolution or of
    a few xLSTM prefills took a minute or more to parse). It is taken
    again, each time of a new ``run()``, up to 3 traces, while no marker
    is left before or after every other kernel or ``whole(kernels)`` is
    false; with ``retake`` false it is taken once and a missing frame
    reported: a revolution, which a new run would advance, and the
    profiles of whole calls, steps and runs (phases 4-14), whose traces
    of thousands of kernels take seconds to read and whose retakes have
    lost their leading markers as well on the H100 so far. The
    last trace is returned as it is, for the caller's checks to judge."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    attempts = 3 if retake else 1
    for attempt in range(attempts):
        with profile(activities=acts) as prof:
            time.sleep(0.02)
            for _ in range(PROFILE_EDGE):
                torch.cuda._sleep(1000)
            run()
            for _ in range(PROFILE_EDGE):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == cuda]
        spins = [e.time_range.start for e in evs if "spin_kernel" in e.name]
        work = [e.time_range.start for e in evs
                if "spin_kernel" not in e.name]
        lead = sum(t <= min(work) for t in spins) if work else 0
        tail = sum(t >= max(work) for t in spins) if work else 0
        kern = [e for e in prof.key_averages()
                if e.device_type == cuda and "spin_kernel" not in e.key]
        if lead and tail and (whole is None or whole(kern)):
            break
        print(f"  (torch.profiler trace {attempt + 1} of {attempts} is not "
              f"whole: markers before the work {lead} of {PROFILE_EDGE}, "
              f"after it {tail} of {PROFILE_EDGE})")
    return kern


def profile_calls(fn, n, what, label):
    """Kernel time by name over ``n`` calls of ``fn`` (each returning host
    values, so synced), against the same calls' host-clock time."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    call = (time.perf_counter() - t0) / n * 1e3

    def run():
        for _ in range(n):
            fn()
    kern = cuda_events(run, retake=False)
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    busy = sum(dev_us(e) for e in kern) / n / 1e3
    if busy == 0:
        print(f"profile: {what} {call:.2f} ms each; device time not measured "
              "(the profiler saw no kernels)")
        return
    print(f"profile of {n} {what} [{label}]: {call:.2f} ms each (host clock, "
          f"unprofiled), kernels {busy:.3f} ms each, device idle "
          f"{max(0.0, 1 - busy / call):.1%}")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / n / 1e3:8.4f} ms each  "
              f"{e.count / n:6.1f}x  {e.key[:90]}")
    ours = {}
    for e in kern:
        name = next((k for k in OUR_KERNELS if f"::{k}" in e.key), None)
        if name:
            c, t = ours.get(name, (0, 0.0))
            ours[name] = (c + e.count / n, t + dev_us(e) / n / 1e3)
    if ours:
        total = sum(t for _, t in ours.values())
        print(f"  this repo's kernels: {total:.4f} ms each ({total / busy:.1%} "
              f"of kernel time): " + ", ".join(
                  f"{k} {c:g}x {t:.4f} ms" for k, (c, t) in ours.items()))


# The functions in csrc/*.cu, as the profiler names them.
OUR_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel",
               "decode_split_kernel", "ssd_kernel", "ssd_chunk_kernel",
               "ssd_state_kernel", "ssd_out_kernel", "mlstm_chunk_kernel",
               "mlstm_norm_kernel", "mlstm_value_kernel", "mlstm_fma_kernel",
               "quant_kernel", "quant_cm_kernel")


def profile_decode(engine, label, steps=5):
    """Kernel time by name over a few decode steps of the served engine
    (torch.profiler), against the same steps' host-clock time."""
    toks = engine.last_tok.reshape(-1, 1).astype(np.int32)
    pos = np.minimum(engine.positions, engine.s_max - 2)
    profile_calls(lambda: engine._step(toks, pos), steps, "decode steps",
                  label)


def train_full_width(label):
    """Phase 5: the ResNet-18 ring at full width through the quantizer."""
    adapter = sl_step.resnet18_adapter(cut=RESNET18_PAPER_CUTS["l2"],
                                       img=224)
    shards = ImageryShards(img=224, batch=RING_BATCH, n_shards=25)
    budget = PassBudget()                      # Table I: 25 sats, 400 items
    check(budget.plane.n_sats == 25 and budget.n_items == 400,
          "Table-I plane")
    with tempfile.TemporaryDirectory() as handoff_dir:
        sim = ConstellationSim(
            adapter, budget, shards.batch_at,
            ConstellationConfig(
                n_passes=RING_PASSES, optimizer="sgd",
                quantize_boundary=True, fail_prob=0.0,
                max_steps_per_pass=RING_STEPS, handoff_dir=handoff_dir),
            device="cuda")
        # warm-up on a throwaway state (cuDNN and cuBLAS handles, allocator)
        warm = SLTrainState.create(*adapter.init(torch.Generator(
            device="cuda").manual_seed(1)), sim.optimizer)
        sim.sl_pass(warm, [shards.batch_at(0, 0)])
        del warm

        split_quant.quantize_dequantize.launches = 0
        split_quant.quantize_rows.launches = 0
        split_quant.copies = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = split_quant.quantize_dequantize.launches
        other = (split_quant.quantize_rows.launches, split_quant.copies)
        handoffs = sorted(Path(handoff_dir).iterdir())
    steps = int(sim.state.step)
    check(steps == sum(min(max(1, round(r.n_items / RING_BATCH)), RING_STEPS)
                       for r in records if r.action in ("trained", "shed")),
          "step counter == the passes' allocated steps")
    check(launches == 2 * steps > 0,
          f"fused quantizer launches {launches} != 2 x {steps} SL steps")
    check(other == (0, 0), f"quantize_rows launches and wrapper copies "
          f"{other} on the ring (want none)")
    check(all(r.loss is not None and np.isfinite(r.loss) for r in records),
          "every pass trained with a finite loss")
    check(len(handoffs) == RING_PASSES, "one handoff checkpoint per pass")
    batch = shards.batch_at(0, 0)
    bits = sl_step.boundary_bits(adapter, batch, True) / RING_BATCH
    check(bits == L2_INT8_BITS_PER_ITEM and 4 * bits == L2_F32_DTX_BITS
          == adapter.costs().dtx_bits, f"boundary payload {bits} bits/item")

    # one SL step from the trained state, kernel vs plain quantizer
    step = sl_step.make_sl_step(adapter, quantize_boundary=True)
    pa, pb = sim.state.params_a, sim.state.params_b
    rk = step(pa, pb, batch)
    kernel_quant = split_quant.quantize_dequantize
    split_quant.quantize_dequantize = split_quant.quantize_dequantize_plain
    try:
        rp = step(pa, pb, batch)
    finally:
        split_quant.quantize_dequantize = kernel_quant
    lk, lp = float(rk.loss), float(rp.loss)
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), (lk, lp))
    g_err = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(rk.grads_a), tree_leaves(rp.grads_a)))

    layout = boundary_layout(adapter, pa, pb, batch)

    # SL step time on device-resident batches (no data generation)
    t0 = time.perf_counter()
    host_batches = [shards.batch_at(1, i) for i in range(RING_STEPS)]
    gen_ms = (time.perf_counter() - t0) / RING_STEPS * 1e3
    dev_batches = [{k: torch.as_tensor(v, device="cuda")
                    for k, v in b.items()} for b in host_batches]
    state, pass_ms = sim.state, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.sl_pass(state, dev_batches)
        float(res.losses[-1])                       # ends in a device sync
        pass_ms.append((time.perf_counter() - t0) * 1e3)
        state = res.state
    step_ms = statistics.median(pass_ms) / RING_STEPS
    print(f"train resnet18 224px cut l2 batch {RING_BATCH}, 25-sat Table-I "
          f"ring, {RING_PASSES} passes x {RING_STEPS} steps, int8 boundary, "
          f"sgd [{label}]")
    print(f"  actions {[r.action for r in records]}; losses "
          f"{[round(r.loss, 4) for r in records]}")
    print(f"  ring: {steps} SL steps in {wall:.3f} s = {steps / wall:.2f} "
          f"steps/s incl. host data generation, planning and handoffs "
          f"[{label}]")
    print(f"  host data generation (NumPy ImageryShards.batch_at): "
          f"{gen_ms:.2f} ms per batch of {RING_BATCH} [{label}]")
    print(f"  SL step on device batches: {step_ms:.2f} ms "
          f"({1e3 / step_ms:.1f} steps/s), median of 3 passes of "
          f"{RING_STEPS} steps, host clock ending in a sync [{label}]")
    print(f"  fused quantizer launches {launches} = 2 x {steps} steps, "
          f"quantize_rows launches and wrapper copies {other}; boundary "
          f"{bits:.0f} bits/item int8 = 1/4 of {L2_F32_DTX_BITS}; step loss "
          f"kernel {lk:.7f} vs plain {lp:.7f}, grads_a max abs diff "
          f"{g_err:.3e}")
    print(f"  {layout} [{label}]")
    profile_sl_steps(sim.sl_pass, state, dev_batches[:4], label)
    return launches, gen_ms


def device_ms(fn, flush, n=20):
    """Device time per call of ``fn`` by kernel, from torch.profiler (no
    host gaps, unlike a pair of events around a Python call): a list of
    (kernel name, launches per call, ms per call). ``flush`` is zeroed
    before each call and its fill left out."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            flush.zero_()
            fn()
    is_fill = lambda e: "FillFunctor" in e.key or "Memset" in e.key
    # whole: every call's flush is in the trace
    kern = cuda_events(run, whole=lambda kern: sum(
        e.count for e in kern if is_fill(e)) >= n)
    return [(e.key, e.count / n,
             getattr(e, "self_device_time_total", 0) / n / 1e3)
            for e in kern if not is_fill(e)]


def boundary_layout(adapter, pa, pb, batch):
    """How z and dz reach the quantizer (strides), and the device time of
    the STE forward (``ops.ste_quantize``) on them as the step hands them
    over, by kernel: each crossing must be one launch of the quantizer
    kernel and nothing else (no copy, no elementwise pass). Then segment
    B's forward and backward on the quantized z in z's strides, against
    the same on an NHWC-contiguous z (the quantizer's output layout before
    it kept x's strides): the device time of both and the kernels only
    one of them runs. Run after the main path's count is read."""
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    with torch.no_grad():
        z = adapter.forward_a(pa, b)
    z_tx = ops.ste_quantize(z).requires_grad_()
    with torch.enable_grad():
        dz, = torch.autograd.grad(adapter.loss_b(pb, z_tx, b), z_tx)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    parts = [f"empty event pair {time_ms(lambda: None, flush=flush):.4f} ms"]
    for name, t in (("z", z), ("dz", dz)):
        kern = device_ms(lambda: ops.ste_quantize(t), flush)
        check(len(kern) == 1 and kern[0][1] == 1
              and any(f"::{k}<" in kern[0][0] for k in ("quant_kernel",
                                                         "quant_cm_kernel")),
              f"{name}: one quantizer kernel per crossing, got {kern}")
        parts.append(f"{name} {tuple(t.shape)} stride {t.stride()} "
                     f"contiguous {t.is_contiguous()}: STE forward "
                     f"{kern[0][2]:.4f} ms of device time per call, one "
                     f"kernel ({kern[0][0][:56]})")

    pbg = map_tree(lambda t: t.detach().requires_grad_(), pb)

    def segment_b(zin):
        def run():
            zz = zin.detach().requires_grad_()
            with torch.enable_grad():
                torch.autograd.grad(adapter.loss_b(pbg, zz, b),
                                    [zz] + tree_leaves(pbg))
        return run

    kept = device_ms(segment_b(z_tx), flush, n=5)
    dense = device_ms(segment_b(z_tx.contiguous()), flush, n=5)
    names = lambda kern: {k for k, *_ in kern}
    only = lambda a, b_: ", ".join(f"{k[:64]} {c:g}x {ms:.4f} ms"
                                   for k, c, ms in a
                                   if k not in names(b_)) or "none"
    parts.append(f"segment B fwd+bwd: z in its strides "
                 f"{sum(ms for *_, ms in kept):.4f} ms of device time, "
                 f"NHWC-contiguous {sum(ms for *_, ms in dense):.4f} ms; "
                 f"kernels only with NHWC-contiguous z: {only(dense, kept)}; "
                 f"only with z in its strides: {only(kept, dense)}")
    return ("boundary layout on the card (torch.profiler, L2 flushed): "
            + "; ".join(parts))


def profile_sl_steps(sl_pass, state, batches, label):
    """Kernel time by name over one pass of a few SL steps, against the
    same pass's host-clock time."""
    n = len(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sl_pass(state, batches)
    float(res.losses[-1])
    step = (time.perf_counter() - t0) / n * 1e3

    def run():
        nonlocal res
        res = sl_pass(res.state, batches)
        float(res.losses[-1])
    kern = cuda_events(run)
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    busy = sum(dev_us(e) for e in kern) / n / 1e3
    if busy == 0:
        print(f"profile: SL step {step:.2f} ms; device time not measured "
              "(the profiler saw no kernels)")
        return
    print(f"profile of {n} SL steps [{label}]: step {step:.2f} ms (host "
          f"clock, unprofiled), kernels {busy:.3f} ms/step, device idle "
          f"{max(0.0, 1 - busy / step):.1%}")
    for e in sorted(kern, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / n / 1e3:8.4f} ms/step  "
              f"{e.count / n:6.1f}x  {e.key[:90]}")
    quant = [e for e in kern if any(f"::{k}<" in e.key for k in (
        "quant_kernel", "quant_cm_kernel"))]
    print("  the boundary's kernels: " + (", ".join(
        f"{e.key[:56]} {e.count / n:g}x {dev_us(e) / n / 1e3:.4f} ms/step"
        for e in quant) or "none"))


def autoencoder_pass_224(label):
    """One autoencoder pass at 224 px: the quantizer at d = 3."""
    adapter = sl_step.autoencoder_adapter(cut=5, img=224)
    shards = ImageryShards(img=224, batch=RING_BATCH, n_shards=1)
    opt = resolve_optimizer("sgd", lr=1e-2)
    state = SLTrainState.create(*adapter.init(torch.Generator(
        device="cuda").manual_seed(0)), opt)
    sl_pass = sl_step.make_sl_pass(adapter, quantize_boundary=True,
                                   optimizer=opt)
    batches = [shards.batch_at(0, i) for i in range(4)]
    n0 = split_quant.quantize_dequantize.launches
    c0 = split_quant.copies
    res = sl_pass(state, batches)
    losses = res.losses.tolist()
    check(split_quant.quantize_dequantize.launches - n0 == 2 * len(batches),
          "2 fused quantizer launches per autoencoder step")
    check(split_quant.copies == c0, "no copy of the autoencoder latent")
    check(all(np.isfinite(losses)), f"autoencoder losses {losses}")
    check(res.dtx_bits_down == RING_BATCH * 7 * 7 * 3 * 8,
          "autoencoder latent payload")
    print(f"train autoencoder 224px cut 5, one pass of {len(batches)} steps "
          f"[{label}]: losses {[round(x, 5) for x in losses]}, boundary "
          f"{res.dtx_bits_down} bits per step (8x7x7x3 int8)")


# Phase 8a: one revolution of the Table-I plane on the device engine, at
# phase 5's width, against the host engine; the reference's host-vs-device
# tolerances (tests/test_device_sim.py:33-52). Capped at 6 SL steps a
# pass, so every pass executes K = bucket_size(6) = 8 steps, 2 of them
# masked, and two satellites start at 90 J, below the 100 J reserve, so
# their passes are skipped (all 8 steps masked). Solar recharge at 1 mW
# (0.23 J a 227-s pass) keeps them below it until their turn.
LOOP_TOL = dict(loss=(2e-4, 1e-5), battery=(1e-5, 0.05), e_total=(1e-5, 1e-9))
LOOP_STEPS, LOOP_LOW_SATS, LOOP_LOW_J, LOOP_RECHARGE_W = (
    6, (3, 17), 90.0, 1e-3)
# Phase 8b: examples/constellation_device_sim.py's single ring (60-71),
# with the int8 boundary on; skips need a third revolution (200 J, ~48 J
# a pass, reserve 150 J).
BIG_RING, BIG_REVS = 1000, 3
# ... and the host engine, timed on a cut of its first revolution
HOST_PASSES = 250


def quant_kernels(kern):
    """(launches, device ms) of the quantizer kernel among a trace's
    kernels."""
    ev = [e for e in kern if any(f"::{k}<" in e.key for k in (
        "quant_kernel", "quant_cm_kernel"))]
    return (sum(e.count for e in ev),
            sum(getattr(e, "self_device_time_total", 0) for e in ev) / 1e3)


def profile_revolution(eng, label, steps):
    """One more revolution of ``eng`` (``steps`` executed SL steps),
    unprofiled (host clock, ending in the engine's telemetry read) then
    profiled once (a kernel-only trace): card time by kernel, idle share,
    and the quantizer's launches seen by the profiler, which hold the
    trace to the wrapper's count."""
    t0 = time.perf_counter()
    eng.run(1)
    wall = time.perf_counter() - t0
    counted = 0

    def run():
        nonlocal counted
        n0 = split_quant.quantize_dequantize.launches
        eng.run(1)
        counted = split_quant.quantize_dequantize.launches - n0
    kern = cuda_events(run, retake=False)
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    busy = sum(dev_us(e) for e in kern) / 1e3
    q_n, q_ms = quant_kernels(kern)
    check(busy > 0, "the profiler saw the revolution's kernels")
    check(q_n == counted == 2 * steps,
          f"quantizer launches: profiler {q_n}, wrapper {counted}")
    print(f"  profile of one revolution [{label}]: {wall * 1e3:.1f} ms host "
          f"clock (unprofiled), {busy:.1f} ms of card time, device idle "
          f"{max(0.0, 1 - busy / (wall * 1e3)):.1%}; per executed step "
          f"{wall * 1e3 / steps:.3f} ms host clock, {busy / steps:.3f} ms "
          f"of card time; quantizer {q_n} launches (profiler = wrapper "
          f"count), {q_ms:.3f} ms")
    for e in sorted(kern, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:80]}")
    return wall, busy


def device_loop_full_width(label, numpy_gen_ms):
    """Phase 8a: the device engine at full width against the host engine."""
    adapter = sl_step.resnet18_adapter(cut=RESNET18_PAPER_CUTS["l2"],
                                       img=224)
    shards = DeviceImageryShards(img=224, batch=RING_BATCH, device="cuda")
    budget = PassBudget()                      # Table I: 25 sats, 400 items
    cfg = ConstellationConfig(n_passes=budget.plane.n_sats, optimizer="sgd",
                              quantize_boundary=True,
                              max_steps_per_pass=LOOP_STEPS,
                              recharge_w=LOOP_RECHARGE_W)
    host = ConstellationSim(adapter, budget, shards, cfg, device="cuda")
    dev = ConstellationSim(adapter, budget, shards, cfg, device="cuda")
    for sim in (host, dev):              # the device engine takes them over
        for i in LOOP_LOW_SATS:
            sim.sats[i].battery_j = LOOP_LOW_J
    warm = SLTrainState.create(*adapter.init(torch.Generator(
        device="cuda").manual_seed(1)), host.optimizer)
    host.sl_pass(warm, [shards(0, 0)])            # cuDNN/cuBLAS handles
    del warm
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.run()
        torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
        split_quant.quantize_dequantize.launches = 0
        split_quant.quantize_rows.launches = 0
        split_quant.copies = 0
        t0 = time.perf_counter()
        dev.run(engine="device")                  # ends in its telemetry read
        wall = time.perf_counter() - t0
        launches = split_quant.quantize_dequantize.launches
        other = (split_quant.quantize_rows.launches, split_quant.copies)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    eng = dev.device_engine
    steps = eng.scan_steps
    skipped = [r.sat_id for r in dev.records if r.action == "skipped_energy"]
    planned = set(eng._host_plan.n_steps.tolist())
    check(skipped == list(LOOP_LOW_SATS) and planned == {LOOP_STEPS}
          and steps == bucket_size(LOOP_STEPS) > LOOP_STEPS,
          f"masked steps: skipped sats {skipped}, planned steps {planned}, "
          f"executed {steps} a pass")
    check(launches == 2 * budget.plane.n_sats * steps > 0,
          f"quantizer launches {launches} != 2 x {budget.plane.n_sats} "
          f"passes x {steps} steps")
    check(other == (0, 0), f"quantize_rows launches and copies {other}")
    check(eng.traces == 1 and eng.device_calls == eng.host_syncs == 1,
          f"one build, dispatch and sync: {eng.traces}, {eng.device_calls}, "
          f"{eng.host_syncs}")
    acts = [r.action for r in host.records]
    check([r.action for r in dev.records] == acts,
          f"actions: host {acts}, device {[r.action for r in dev.records]}")
    errs = dict(loss=0.0, battery=0.0, e_total=0.0)
    for h, d in zip(host.records, dev.records):
        for key, hv, dv in (("loss", h.loss, d.loss),
                            ("battery", h.battery_j, d.battery_j),
                            ("e_total", h.e_total_j, d.e_total_j)):
            if hv is None:
                check(dv is None, "a skipped pass has no loss")
                continue
            rtol, atol = LOOP_TOL[key]
            check(np.isfinite(dv) and abs(dv - hv) <= atol + rtol * abs(hv),
                  f"{key}: device {dv} host {hv}")
            errs[key] = max(errs[key], abs(dv - hv) / max(abs(hv), 1e-30))
    valid = sum(min(max(1, round(r.n_items / RING_BATCH)), LOOP_STEPS)
                for r in dev.records if r.loss is not None)
    print(f"device loop resnet18 224px cut l2 batch {RING_BATCH}, one "
          f"revolution of the 25-sat Table-I plane, {LOOP_STEPS} SL steps "
          f"of {steps} executed a pass, sats {list(LOOP_LOW_SATS)} at "
          f"{LOOP_LOW_J:g} J (reserve {cfg.reserve_j:g} J), recharge "
          f"{LOOP_RECHARGE_W:g} W, int8 boundary, sgd, TF32 off, cudnn.deterministic "
          f"[{label}]")
    print(f"  actions {acts}; losses "
          f"{[r.loss and round(r.loss, 4) for r in dev.records]}")
    print(f"  device engine == host engine: actions equal; largest relative "
          f"difference loss {errs['loss']:.2e}, battery {errs['battery']:.2e}, "
          f"e_total {errs['e_total']:.2e}; no host sync inside the "
          f"revolution (sync-debug mode 'error' around it)")
    print(f"  device engine: 25 passes in {wall:.3f} s = {25 / wall:.2f} "
          f"passes/s, {valid / wall:.2f} valid SL steps/s incl. planning "
          f"and the telemetry read; host engine (same provider) "
          f"{host_wall:.3f} s = {valid / host_wall:.2f} steps/s [{label}]")
    print(f"  masked steps {25 * steps - valid} of {25 * steps}: "
          f"{len(skipped)} skipped passes x {steps} + {25 - len(skipped)} "
          f"passes x {steps - LOOP_STEPS} beyond the allocation; quantizer "
          f"launches {launches} = 2 x 25 passes x {steps} executed steps "
          f"(masked included), quantize_rows launches and copies {other}")
    rev_wall, busy = profile_revolution(eng, label,
                                        eng.n_sats * eng.scan_steps)

    # batch generation on the card (per batch) beside phase 5's NumPy
    sat, idx = torch.arange(25, device="cuda")[3:4], eng._batch_idx + 0
    gen_ms = time_ms(lambda: shards(sat, idx))
    print(f"  batch generation on the card (DeviceImageryShards, {RING_BATCH}"
          f"x224x224x3 + labels): {gen_ms:.3f} ms per batch (CUDA events, "
          f"median of 20) vs NumPy ImageryShards {numpy_gen_ms:.2f} ms in "
          f"phase 5 [{label}]")
    # the plan: 25 instances, float64 on the card vs the NumPy planner
    costs, times = eng.costs, {"torch": [], "numpy": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = plan_ring_passes(budget, costs, batch_size=RING_BATCH,
                                max_steps_per_pass=RING_STEPS, device="cuda")
        int(plan.n_steps[0])                         # ends in a sync
        times["torch"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        resource_opt.solve_with_shedding_batch([budget] * 25, [costs] * 25,
                                               backend="numpy")
        times["numpy"].append((time.perf_counter() - t0) * 1e3)
    print(f"  plan of 25 instances: torch float64 on the card "
          f"{statistics.median(times['torch']):.2f} ms (80 masked bisection "
          f"steps, host clock ending in a sync), NumPy planner "
          f"{statistics.median(times['numpy']):.2f} ms (median of 5) "
          f"[{label}]")
    return launches


def boundary_bitwise(adapter, state, batch, shapes=QUANT_CM_SHAPES):
    """z and dz of one SL step as the step hands them to the quantizer,
    each held bit for bit against the plain version by both entries, with
    no copy; each must be one of phase 3's ``shapes``. Run after the main
    path's count is read."""
    with torch.no_grad():
        z = adapter.forward_a(state.params_a, batch)
    z_tx = ops.ste_quantize(z).requires_grad_()
    with torch.enable_grad():
        dz, = torch.autograd.grad(adapter.loss_b(state.params_b, z_tx, batch),
                                  z_tx)
    parts = []
    for name, t in (("z", z), ("dz", dz)):
        check((tuple(t.shape), t.dtype) in shapes,
              f"{name} {tuple(t.shape)} {t.dtype} is not a phase-3 shape")
        for entry, plain in ((split_quant.quantize_dequantize,
                              split_quant.quantize_dequantize_plain),
                             (split_quant.quantize_rows,
                              split_quant.quantize_rows_plain)):
            c0 = split_quant.copies
            got, want = flat(entry(t)), flat(plain(t))
            check(split_quant.copies == c0
                  and all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{name}: {entry.__name__} not bit-identical to plain, or "
                  f"copied, at the path's boundary")
        parts.append(f"{name} {tuple(t.shape)} stride {t.stride()}")
    return parts


def device_loop_1000(label):
    """Phase 8b: the reference example's 1000-satellite ring, then one
    revolution of the host engine on the same ring for its time."""
    adapter = sl_step.autoencoder_adapter(cut=5, img=32)
    shards = DeviceImageryShards(img=32, batch=2, device="cuda")
    budget = PassBudget(plane=OrbitalPlane(n_sats=BIG_RING), n_items=4e6)
    knobs = dict(battery_j=200.0, recharge_w=1e-4, reserve_j=150.0,
                 max_steps_per_pass=2, quantize_boundary=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = DeviceConstellationSim(adapter, budget, shards, DeviceSimConfig(
        n_revolutions=BIG_REVS, **knobs), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    split_quant.quantize_dequantize.launches = 0
    split_quant.copies = 0
    rows, actions = [], []
    torch.cuda.synchronize()
    for rev in range(BIG_REVS):
        t0 = time.perf_counter()
        res = eng.run(1, stream_telemetry=True)
        actions.append(res.action[0].tolist())
        rows.append((time.perf_counter() - t0,
                     int((res.action == ACTION_SKIPPED).sum()),
                     float(np.nanmean(res.loss)) if np.isfinite(
                         res.loss).any() else float("nan")))
    launches = split_quant.quantize_dequantize.launches
    check(eng.traces == 1 and eng.device_calls == eng.host_syncs == BIG_REVS,
          f"one sync per revolution: {eng.traces} builds, "
          f"{eng.device_calls} dispatches, {eng.host_syncs} syncs")
    check(rows[-1][1] > 0, f"reserve skips by revolution {BIG_REVS - 1}")
    check(launches == 2 * BIG_RING * eng.scan_steps * BIG_REVS
          and split_quant.copies == 0, f"quantizer launches {launches}")
    check(np.isfinite(rows[0][2]), "finite losses")
    print(f"device loop autoencoder 32px batch 2, {BIG_RING}-sat ring, "
          f"{BIG_REVS} streamed revolutions, {eng.scan_steps} steps/pass, "
          f"int8 boundary [{label}]")
    print(f"  device engine: construction {build_s:.3f} s (boundary "
          f"measured on the meta device, the {BIG_RING}-instance plan in "
          f"float64 "
          f"on the card)")
    for rev, (s, skipped, loss) in enumerate(rows):
        print(f"  rev {rev}: {s:.3f} s = {BIG_RING / s:.1f} passes/s, "
              f"skipped {skipped}, mean loss {loss:.4f} [{label}]")
    print(f"  {eng.traces} build, {eng.device_calls} dispatches, "
          f"{eng.host_syncs} telemetry syncs; quantizer launches {launches} "
          f"= 2 x {BIG_RING} x {eng.scan_steps} x {BIG_REVS}")
    sat = torch.zeros(1, dtype=torch.int64, device="cuda")
    parts = boundary_bitwise(adapter, eng.state, shards(sat, eng._batch_idx))
    print(f"  the boundary as the ring hands it over: {'; '.join(parts)}; "
          f"both entries bit-identical to plain, no copy")

    # the host engine on the same ring from a full fleet, cut to the first
    # HOST_PASSES passes of revolution 0: the same 2 steps a pass (all
    # trained); it plans the whole ring with NumPy at its first pass, after
    # peeking each satellite's first batch
    host = ConstellationSim(adapter, budget, shards, ConstellationConfig(
        n_passes=HOST_PASSES, optimizer="sgd", **knobs), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host.planner.entry_for(0, range(BIG_RING), budget,
                           [host._costs_for(s) for s in range(BIG_RING)])
    plan_s = time.perf_counter() - t0
    recs = host.run()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    check(all(r.action == "trained" for r in recs)
          and actions[0] == [ACTION_TRAINED] * BIG_RING,
          f"revolution 0: host {set(r.action for r in recs)}, device "
          f"{set(actions[0])}")
    check(all(np.isfinite(r.loss) for r in recs), "host engine: finite losses")
    check(host.planner.solve_calls == 1, "host engine: one plan")
    pass_s = (host_s - plan_s) / HOST_PASSES
    print(f"  host engine, same ring and provider, the first {HOST_PASSES} "
          f"passes of revolution 0: {host_s:.3f} s, of which the NumPy plan "
          f"of {BIG_RING} instances with its {BIG_RING} batch peeks "
          f"{plan_s:.3f} s; {pass_s * 1e3:.2f} ms a pass = "
          f"{1 / pass_s:.1f} passes/s, a revolution at that rate "
          f"{plan_s + BIG_RING * pass_s:.3f} s with its plan (device engine: "
          f"{rows[0][0]:.3f} s for revolution 0, its plan made at "
          f"construction) [{label}]")
    return launches


# Phase 9a: the fleet engine at phase 8a's width: 2 planes of the Table-I
# ring for one revolution, a join at pass 3 and a leave at pass 5, seeded
# failures (seed 1 at 0.08: plane 0 fails at pass 9, plane 1 at pass 7),
# satellites 3 and 17 of each plane below reserve (skips), 6 SL steps of 8
# executed a pass (masked steps), planes averaged at the boundary; held
# against the host engine per plane (seed + p, data ids offset p * M).
FLEET_PLANES, FLEET_SEED, FLEET_FAIL = 2, 1, 0.08
FLEET_EVENTS = dict(join_events={3: 1}, leave_events={5: 1})


def fleet_full_width(label):
    """Phase 9a: two full-width planes on the fleet engine against the host
    engine, plane by plane, and the average at the revolution boundary."""
    adapter = sl_step.resnet18_adapter(cut=RESNET18_PAPER_CUTS["l2"],
                                       img=224)
    shards = DeviceImageryShards(img=224, batch=RING_BATCH, device="cuda")
    budget = PassBudget()                      # Table I: 25 sats, 400 items
    n0 = budget.plane.n_sats
    knobs = dict(optimizer="sgd", quantize_boundary=True,
                 max_steps_per_pass=LOOP_STEPS, recharge_w=LOOP_RECHARGE_W,
                 fail_prob=FLEET_FAIL, **FLEET_EVENTS)
    battery0 = [LOOP_LOW_J if i in LOOP_LOW_SATS else 5_000.0
                for i in range(n0)]
    opt = resolve_optimizer("sgd")
    init = adapter.init(torch.Generator(device="cuda").manual_seed(
        FLEET_SEED))

    def fresh():
        return SLTrainState.create(*[map_tree(torch.clone, t) for t in init],
                                   opt)

    fleet = FleetEngine(adapter, budget, shards, FleetConfig(
        n_planes=FLEET_PLANES, n_revolutions=1, seed=FLEET_SEED,
        avg_every=1, **knobs), state=fresh(), battery0=battery0,
        device="cuda")
    M, K = fleet.n_slots, fleet.scan_steps
    hosts = []
    for p in range(FLEET_PLANES):
        host = ConstellationSim(
            adapter, budget, lambda s, i, p=p: shards(p * M + s, i),
            ConstellationConfig(n_passes=n0, seed=FLEET_SEED + p, **knobs),
            device="cuda")
        host.state = fresh()
        for i in LOOP_LOW_SATS:
            host.sats[i].battery_j = LOOP_LOW_J
        hosts.append(host)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for host in hosts:
            host.run()
        torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
        split_quant.quantize_dequantize.launches = 0
        split_quant.quantize_rows.launches = 0
        split_quant.copies = 0
        t0 = time.perf_counter()
        res = fleet.run(stream_telemetry=True)    # ends in its one read
        wall = time.perf_counter() - t0
        launches = split_quant.quantize_dequantize.launches
        other = (split_quant.quantize_rows.launches, split_quant.copies)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    executed = FLEET_PLANES * n0 * K
    check(launches == 2 * executed > 0 and other == (0, 0),
          f"quantizer launches {launches} != 2 x {FLEET_PLANES} planes x "
          f"{n0} passes x {K} steps, or quantize_rows launches and copies "
          f"{other}")
    check(fleet.traces == 1 and fleet.device_calls == fleet.host_syncs == 1,
          f"one build, dispatch and sync: {fleet.traces}, "
          f"{fleet.device_calls}, {fleet.host_syncs}")
    errs = dict(loss=0.0, battery=0.0)
    for p, host in enumerate(hosts):
        acts = [r.action for r in host.records]
        got = [ACTION_NAMES[int(a)] for a in res.action[p]]
        check(got == acts, f"plane {p} actions: host {acts}, fleet {got}")
        check([r.sat_id for r in host.records] == res.sat[p].tolist(),
              f"plane {p} slots: host {[r.sat_id for r in host.records]}, "
              f"fleet {res.sat[p].tolist()}")
        for h, dl, db in zip(host.records, res.loss[p], res.battery_j[p]):
            for key, hv, dv in (("loss", h.loss, dl),
                                ("battery", h.battery_j, db)):
                if hv is None:
                    check(not np.isfinite(dv), "an untrained pass has no loss")
                    continue
                rtol, atol = LOOP_TOL[key]
                check(abs(dv - hv) <= atol + rtol * abs(hv),
                      f"plane {p} {key}: fleet {dv} host {hv}")
                errs[key] = max(errs[key], abs(dv - hv) / max(abs(hv), 1e-30))
        spent = np.asarray([s.energy_spent_j for s in host.sats])
        check(np.allclose(res.energy.energy_spent_j[p], spent,
                          rtol=LOOP_TOL["e_total"][0], atol=1e-3),
              f"plane {p} energy spent: fleet {res.energy.energy_spent_j[p]}"
              f" host {spent}")
    s = res.summary()
    check(s["failed"] > 0 and s["skipped"] > 0 and s["trained"] > 0
          and (res.sat == n0).any(),
          f"failed, skipped, trained passes and the joiner served: {s}")
    # after the boundary every plane holds the mean of the two host states
    # (params and momentum)
    mean_err = 0.0
    host_leaves = [_leaves(h.state._fields()) for h in hosts]
    for p, st in enumerate(res.state):
        for got, *want in zip(_leaves(st._fields()), *host_leaves):
            if not got.is_floating_point():
                continue
            mean = torch.stack(want).mean(dim=0)
            rtol, atol = LOOP_TOL["loss"]
            check(torch.allclose(got, mean, rtol=rtol, atol=atol),
                  f"plane {p}: a leaf differs from the hosts' mean by "
                  f"{(got - mean).abs().max().item():.3e}")
            mean_err = max(mean_err, (got - mean).abs().max().item())
    ev = fleet.recorder.events()
    check(int((ev["kind"] == EV_EXCHANGE).sum()) == FLEET_PLANES,
          "one exchange event per plane at the boundary")
    valid = int(res.n_steps.sum())
    passes = FLEET_PLANES * n0
    print(f"fleet resnet18 224px cut l2 batch {RING_BATCH}, {FLEET_PLANES} "
          f"planes x the 25-sat Table-I ring (+1 join at pass 3, a leave at "
          f"pass 5, fail_prob {FLEET_FAIL} seed {FLEET_SEED}), one "
          f"revolution, {LOOP_STEPS} SL steps of {K} executed a pass, sats "
          f"{list(LOOP_LOW_SATS)} at {LOOP_LOW_J:g} J, int8 boundary, sgd, "
          f"averaged at the boundary, TF32 off, cudnn.deterministic "
          f"[{label}]")
    for p in range(FLEET_PLANES):
        print(f"  plane {p}: actions "
              f"{[ACTION_NAMES[int(a)][:4] for a in res.action[p]]}; slots "
              f"{res.sat[p].tolist()}")
    print(f"  fleet == host engine per plane: actions and slots equal; "
          f"largest relative difference loss {errs['loss']:.2e}, battery "
          f"{errs['battery']:.2e}; after the boundary every plane's params "
          f"and momentum within {mean_err:.2e} of the hosts' mean; "
          f"{fleet.host_syncs} sync for the revolution (sync-debug 'error' "
          f"around it); summary {s}")
    print(f"  fleet: {passes} passes in {wall:.3f} s = {passes / wall:.2f} "
          f"passes/s, {valid / wall:.2f} valid SL steps/s ({valid} valid of "
          f"{executed} executed) incl. the telemetry read; host engines, "
          f"same work: {host_wall:.3f} s = {valid / host_wall:.2f} steps/s "
          f"[{label}]")
    print(f"  quantizer launches {launches} = 2 x {FLEET_PLANES} planes x "
          f"{n0} passes x {K} executed steps (masked included); "
          f"quantize_rows launches and copies {other}")
    profile_revolution(fleet, label, executed)
    return launches


def fleet_smoke_9b(label):
    """Phase 9b: ``python -m repro_torch.fleet``'s smoke on the card (the
    reference smoke's config: 2 planes x 8 satellites, 2 revolutions)."""
    t0 = time.perf_counter()
    s = fleet_smoke(device="cuda")
    check(s["failed"] > 0 and s["skipped"] > 0 and s["trained"] > 0,
          f"failed, skipped and trained passes: {s}")
    print(f"  fleet smoke (2 x 8 sats, 2 revolutions, autoencoder 32 px) "
          f"with its host engines: {time.perf_counter() - t0:.3f} s "
          f"[{label}]")


# Phase 10a: phase 9a's two full-width planes (the join, the leave, the
# seeded failures, satellites 3 and 17 below reserve, 6 SL steps of 8 a
# pass) under the degraded smoke's stressors: eclipses (period 4, duty
# 0.5, stagger 1), an epidemic from slot 0 at pass 0 (beta 0.6, ttl 2;
# pass 0 of each plane is a fault) and slot 1 of plane 0 sign-flipping its
# updates; no free average, the async int8 ISL gossip instead, every 4
# passes to the next plane (mix 0.5, staleness lambda 0.1). Held against
# the NumPy action and exchange oracles bit for bit.
P10_SCENARIO = ScenarioConfig(
    eclipse=EclipseConfig(period=4, duty=0.5, stagger=1),
    byzantine=ByzantineConfig(slots={0: [1]}, mode="sign_flip", scale=1.0),
    epidemic=EpidemicConfig(beta=0.6, ttl=2, init_slots=(0,), start=0))
P10_EXCHANGE = ExchangeConfig(mode="async", codec=CodecConfig("int8"),
                              contact=ContactConfig(period=4, offsets=(1,)),
                              mix=0.5, staleness_lam=0.1)


def degraded_fleet_full_width(label, flush):
    """Phase 10a: the fleet at full width under eclipses, an epidemic, a
    Byzantine slot and the async int8 ISL gossip, against the oracles;
    then one push's codec, leaf by leaf, kernel against plain version,
    and the codec's largest leaf timed. Returns the B1 launches of the
    run."""
    t_phase = time.perf_counter()
    adapter = sl_step.resnet18_adapter(cut=RESNET18_PAPER_CUTS["l2"],
                                       img=224)
    shards = DeviceImageryShards(img=224, batch=RING_BATCH, device="cuda")
    budget = PassBudget()                      # Table I: 25 sats, 400 items
    n0 = budget.plane.n_sats
    battery0 = [LOOP_LOW_J if i in LOOP_LOW_SATS else 5_000.0
                for i in range(n0)]
    init = adapter.init(torch.Generator(device="cuda").manual_seed(
        FLEET_SEED))
    state = SLTrainState.create(*[map_tree(torch.clone, t) for t in init],
                                resolve_optimizer("sgd"))
    fleet = FleetEngine(adapter, budget, shards, FleetConfig(
        n_planes=FLEET_PLANES, n_revolutions=1, seed=FLEET_SEED,
        avg_every=0, optimizer="sgd", quantize_boundary=True,
        max_steps_per_pass=LOOP_STEPS, recharge_w=LOOP_RECHARGE_W,
        fail_prob=FLEET_FAIL, scenario=P10_SCENARIO, exchange=P10_EXCHANGE,
        **FLEET_EVENTS), state=state, battery0=battery0, device="cuda")
    check(fleet._ex_on, f"the exchange is off: {fleet._ex_bits} bits over "
          f"a {fleet._ex_cap_bits} bit contact")
    expect_act = oracle_actions(fleet)
    expect_ex = oracle_exchange(fleet)
    K, P = fleet.scan_steps, FLEET_PLANES
    n_leaves = len(_leaves((state.params_a, state.params_b)))
    contacts = P10_EXCHANGE.contact.contacts_in(n0)
    split_quant.quantize_dequantize.launches = 0
    split_quant.quantize_rows.launches = 0
    split_quant.copies = 0
    t0 = time.perf_counter()
    res = fleet.run(stream_telemetry=True)        # ends in its one read
    wall = time.perf_counter() - t0
    launches = split_quant.quantize_dequantize.launches
    other = (split_quant.quantize_rows.launches, split_quant.copies)

    executed = P * n0 * K
    check(launches == 2 * executed + contacts * P * n_leaves > 0
          and other == (0, 0),
          f"quantizer launches {launches} != 2 x {executed} executed steps "
          f"+ {contacts} contacts x {P} planes x {n_leaves} leaves, or "
          f"quantize_rows launches and copies {other}")
    check(fleet.traces == 1 and fleet.device_calls == fleet.host_syncs == 1,
          f"one build, dispatch and sync: {fleet.traces}, "
          f"{fleet.device_calls}, {fleet.host_syncs}")
    check(np.array_equal(res.action, expect_act),
          f"actions {res.action.tolist()} != oracle {expect_act.tolist()}")
    got_ex = exchange_events(fleet.recorder)
    check(got_ex["t"].size == expect_ex["t"].size == contacts,
          f"{got_ex['t'].size} exchanges, oracle {expect_ex['t'].size}, "
          f"schedule {contacts}")
    for col in ("t", "aggregate", "slot", "bits", "e_isl_j", "staleness",
                "weight"):
        check(np.array_equal(got_ex[col], expect_ex[col]),
              f"exchange column {col}: {got_ex[col]} != {expect_ex[col]}")
    faults = int((res.action == ACTION_FAULT).sum())
    check(faults > 0 and (res.action[:, 0] == ACTION_FAULT).all(),
          f"pass 0 of every plane is an epidemic fault: {res.action[:, 0]}")
    trained1 = (res.action[1] == ACTION_TRAINED) | \
        (res.action[1] == ACTION_SHED)
    check(trained1.any() and np.isfinite(res.loss[1][trained1]).all(),
          "plane 1's trained passes have finite losses")
    check(res.isl_bits.sum() > 0 and res.isl_e_j.sum() > 0
          and (res.isl_contacts == contacts).all(),
          f"ISL meters: bits {res.isl_bits}, J {res.isl_e_j}, contacts "
          f"{res.isl_contacts}")
    s = res.summary()

    # one push of plane 0's codec after the run, leaf by leaf: the kernel's
    # reconstruction against the plain version's on the same accumulated
    # delta (params - anchor + residual), and the whole push on the card
    # against the same push on the host
    ex = fleet._ex_state
    params = (res.state[0].params_a, res.state[0].params_b)
    accs = [(p.float() - a + r) for p, a, r in zip(
        _leaves(params), _leaves(ex.anchor[0]), _leaves(ex.residual[0]))]
    for acc in accs:
        x2 = acc.reshape(1, -1) if acc.dim() < 2 else \
            acc.reshape(-1, acc.shape[-1])
        check(torch.equal(split_quant.quantize_dequantize(x2),
                          split_quant.quantize_dequantize_plain(x2)),
              f"codec leaf {tuple(acc.shape)}: kernel != plain")
    kept, resid = encode_delta(params, ex.anchor[0], ex.residual[0],
                               P10_EXCHANGE.codec)
    to_cpu = lambda t: map_tree(lambda x: x.cpu(), t)          # noqa: E731
    kept_h, resid_h = encode_delta(to_cpu(params), to_cpu(ex.anchor[0]),
                                   to_cpu(ex.residual[0]), P10_EXCHANGE.codec)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(
        _leaves((kept, resid)), _leaves((kept_h, resid_h)))),
        "a push's codec on the card != the same push on the host")
    big = max(accs, key=lambda t: t.numel())
    row = check_quant(f"codec leaf {tuple(big.shape)} f32 as "
                      f"{tuple(big.reshape(-1, big.shape[-1]).shape)} rows",
                      big.reshape(-1, big.shape[-1]), True, flush)

    valid = int(res.n_steps.sum())
    print(f"fleet resnet18 224px cut l2 batch {RING_BATCH}, {P} planes x the "
          f"25-sat Table-I ring as phase 9a, one revolution, eclipses "
          f"(period 4, duty 0.5, stagger 1), epidemic (beta 0.6, ttl 2, "
          f"slot 0 at pass 0), slot 1 of plane 0 sign-flipping, async int8 "
          f"gossip every 4 passes (mix 0.5, lambda 0.1), no free average "
          f"[{label}]")
    for p in range(P):
        print(f"  plane {p}: actions "
              f"{[ACTION_NAMES[int(a)][:4] for a in res.action[p]]}; "
              f"infected {res.n_infected[p].tolist()}")
    print(f"  fleet == oracles: actions and {contacts} EV_EXCHANGE rows bit "
          f"for bit; {faults} faulted passes; {fleet.host_syncs} sync for "
          f"the revolution (sync-debug 'error' around it); ISL "
          f"{res.isl_bits.tolist()} bits, {res.isl_e_j.tolist()} J, "
          f"{res.isl_contacts.tolist()} pushes; summary {s}")
    print(f"  quantizer launches {launches} = 2 x {executed} executed SL "
          f"steps + {contacts} contacts x {P} planes x {n_leaves} leaves; "
          f"quantize_rows launches and copies {other}; one push's codec "
          f"kernel == plain on all {n_leaves} leaves, card == host")
    print(f"  fleet: {P * n0} passes in {wall:.3f} s = "
          f"{P * n0 / wall:.2f} passes/s, {valid / wall:.2f} valid SL "
          f"steps/s ({valid} valid of {executed} executed) incl. the "
          f"telemetry read and {contacts} pushes [{label}]")
    print(f"  codec leaf {row['shape']}: kernel {row['ms']:.4f} plain "
          f"{row['plain_ms']:.4f} bound {row['bound_ms']:.4f} "
          f"({row['bound_by']}) ms; device time "
          f"{sum(ms for *_, ms in row['device']):.4f} ms, copy_ "
          f"{row['copy_ms']:.4f} ms; phase 10a "
          f"{time.perf_counter() - t_phase:.1f} s [{label}]")
    return launches


def isl_smokes_10b(label):
    """Phase 10b: ``python -m repro_torch.isl`` and ``python -m
    repro_torch.fleet --scenario degraded`` at their reference sizes, on
    the card."""
    t0 = time.perf_counter()
    out = isl_smoke(device="cuda")
    check(out["contacts"] > 0, f"isl smoke: {out}")
    t1 = time.perf_counter()
    s = degraded_smoke(device="cuda")
    check(s["faulted"] > 0 and s["skipped"] > 0, f"degraded smoke: {s}")
    print(f"  isl smoke (2 x 4 sats, 2 revolutions) {t1 - t0:.3f} s, "
          f"degraded smoke (2 x 8 sats, 2 revolutions) "
          f"{time.perf_counter() - t1:.3f} s [{label}]")


# Phase 11a's second half: the reference smoke's traffic (25,000
# users/day, 90 s windows, prompts of 5 tokens, 4 new tokens each, 8
# windows) served by the full-width split engine, whose rate prices the
# serving fleet, and the serving fleet on the card at two sizes: the
# reference smoke's (2 planes x 8 satellites, 24 windows of 90 s,
# eclipses 6 / 0.5, TrainLoad(8, 12)) and a constellation's: 4 planes of
# 256 satellites, 1,000 windows of the Table-I plane's pass duration,
# TrafficConfig() (10^6 users/day, 16-token decodes), eclipses of 16
# windows at duty 0.5 staggered by 4, and batteries whose 0.02 W recharge
# cannot refill a satellite between its visits, so both gates bite. The
# constellation is priced at a fixed BIG_RATE, the measured rate's joules
# a token: whether its batteries reach the reserve depends on the rate
# (below about 39 tok/s no pass skips), and the measured rate follows the
# host's speed (53.9 and 34.6 tok/s on two H100 machines).
BIG_RATE = 60.0
BIG_FLEET = dict(n_planes=4, n_sats=256, n_windows=1000, recharge_w=0.02,
                 reserve_serve_j=50.0, reserve_train_j=250.0,
                 eclipse=EclipseConfig(period=16, duty=0.5, stagger=4))
BIG_TRAIN = TrainLoad(drain_j=120.0, e_total_j=200.0)


def serve_fleet_parity(what, fleet, train, label):
    """One run of a fresh serving fleet on the card under sync-debug
    "error", held to the NumPy oracle (assert_host_parity) with one host
    sync and one EV_SERVE per (plane, window); prints host ms a window,
    the run's wall time, the oracle's time and how far the card's joules
    lie from the oracle's."""
    P, K = fleet.cfg.n_planes, fleet.cfg.n_windows
    t0 = time.perf_counter()
    with sync_budget(1, registry=fleet.metrics):
        res = fleet.run()
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    o = assert_host_parity(res, train)
    oracle_s = time.perf_counter() - t1
    ev = fleet.recorder.events()
    n_serve = int((ev["kind"] == EV_SERVE).sum())
    check(fleet.traces == 1 and fleet.host_syncs == 1
          and n_serve == P * K and fleet.recorder.dropped == 0,
          f"{what}: traces {fleet.traces}, syncs {fleet.host_syncs}, "
          f"{n_serve} EV_SERVE of {P * K}")
    err = max(float(np.abs(res.battery_j - o["battery_j"]).max()),
              float(np.abs(res.energy.energy_spent_j
                           - o["energy_spent_j"]).max()))
    s = res.summary()
    print(f"  serving fleet {what} on the card: {res.run_s * 1e3 / K:.4f} "
          f"ms of host a window, run {res.run_s:.3f} s (wall with the "
          f"inputs {wall:.3f} s), NumPy oracle {oracle_s:.3f} s; parity OK "
          f"(routing and counts exact; joules max |card - oracle| "
          f"{err:.3e}, bit for bit: {err == 0.0}), 1 host sync, {n_serve} "
          f"EV_SERVE [{label}]")
    print(f"    arrivals {s['arrived_requests']} served "
          f"{s['served_requests']:.0f} backlog "
          f"{s['final_backlog_requests']:.0f}, sustained "
          f"{s['sustained_tokens_per_s']:.2f} tok/s, p99 "
          f"{s['p99_latency_s']:.2f} s, trained {s['trained_passes']} "
          f"skipped {s['skipped_passes']}, min battery "
          f"{s['min_battery_j']:.2f} J")
    return res


def granite_serving_fleet_11a(label):
    """Phase 11a: full-width Granite-3.0-2B split at unit 20 through B2
    and B3 (phase 4's checks), the reference smoke's traffic on its split
    engine (its first window with every kernel call held to its plain
    version, every window's tokens to the unsplit engine's), the measured
    rate as a ServeCost, and the serving fleet on the card at two sizes
    against the NumPy oracle. Returns the kernels' launches on the served
    runs."""
    launches, split, params = serve_full_width("granite_3_2b", label)
    cfg, cut = split.cfg, SERVED["granite_3_2b"]["cut"]
    spec = SERVED["granite_3_2b"]

    # the reference smoke's traffic, prompts from PassWindowTraffic
    windows = PassWindowTraffic(SMOKE_TRAFFIC, window_s=90.0, n_planes=1)
    arrivals = windows.realize(8)[0]
    steps = [0]
    step = split._step

    def counted_step(*a):
        steps[0] += 1
        return step(*a)

    split._step = counted_step
    for w in WRAPPERS.values():
        w.launches = 0
    out, dt = serve_windows(split, windows, arrivals, cfg.vocab)
    traffic = {n: w.launches for n, w in WRAPPERS.items()}
    n_req, n_tok = len(out), sum(len(t) for t in out.values())
    want = {**dict.fromkeys(WRAPPERS, 0),
            "flash_attn_fwd": spec["per_prompt"]["flash_attn_fwd"] * n_req,
            "decode_attn": spec["per_step"]["decode_attn"] * steps[0]}
    check(n_req == int(arrivals.sum()) and
          n_tok == n_req * SMOKE_TRAFFIC.decode_len and
          all(0 <= x < cfg.vocab for t in out.values() for x in t),
          f"traffic: {n_req} requests, {n_tok} tokens of "
          f"{int(arrivals.sum())} arrivals")
    check(traffic == want, f"traffic launches {traffic} != {want}")
    rate = n_tok / dt
    n_steps = steps[0]

    # the traffic's shapes (5-token prefills, decode over 5-8 positions)
    # held call by call: the first window again, each B2 and B3 call
    # against its plain version on the same inputs, at phase 3's tolerance
    steps[0] = 0
    (out0, _), calls = with_checked_ops(lambda: serve_windows(
        split, windows, arrivals[:1], cfg.vocab))
    want_calls = {"flash_attention": spec["per_prompt"]["flash_attn_fwd"]
                  * int(arrivals[0]),
                  "decode_attention": spec["per_step"]["decode_attn"]
                  * steps[0]}
    check({n: c[0] for n, c in calls.items()} == want_calls,
          f"checked traffic calls {calls} != {want_calls}")
    check(out0 == {r: out[r] for r in out0},
          "the first window's tokens differ between two runs")
    # every window's tokens against the unsplit engine's
    unsplit, _ = serve_windows(DecodeEngine(cfg, params, **SERVE_KW),
                               windows, arrivals, cfg.vocab)
    check(unsplit == out, "traffic: split and unsplit greedy tokens differ")

    cost = serve_cost(cfg, params, cut, tokens_per_s=rate,
                      act_bits=split.act_dtype.itemsize * 8)
    check(cost.e_token_j > 0, f"serve cost {cost}")
    print(f"  pass-window traffic: {n_req} requests ({arrivals.tolist()} "
          f"over 8 windows of 90 s), {n_tok} tokens in {dt:.3f} s = "
          f"{rate:.1f} tok/s on the split engine, {n_steps} decode steps; "
          f"launches {traffic}; split tokens == unsplit [{label}]")
    print(f"  window 0 again, every kernel call vs plain (calls, err, max "
          f"|plain|): " + ", ".join(f"{n} {c}x ({e:.3e}, {t:.3e})"
                                    for n, (c, e, t) in calls.items())
          + f" [{label}]")
    print(f"  ServeCost at {rate:.1f} tok/s: {cost.e_token_j:.6g} J a token "
          f"on the satellite (units [0, {cut}), {cost.dtx_bits_token:.0f} "
          f"boundary bits), a 90 s window serves "
          f"{cost.window_capacity_requests(90.0, 4):.0f} requests of 4 "
          f"tokens")
    del split, params
    torch.cuda.empty_cache()

    serve_fleet_parity("2 x 8, 24 windows", serve_fleet_smoke_fleet(
        cost, "cuda"), SMOKE_TRAIN, label)
    fleet = FleetServeEngine(ServeFleetConfig(**BIG_FLEET), TrafficConfig(),
                             dataclasses.replace(cost, tokens_per_s=BIG_RATE),
                             train=BIG_TRAIN, device="cuda")
    res = serve_fleet_parity("4 x 256, 1,000 windows of "
                             f"{fleet.cfg.pass_window_s:.2f} s at "
                             f"{BIG_RATE:g} tok/s", fleet,
                             BIG_TRAIN, label)
    check(res.summary()["trained_passes"] > 0
          and res.summary()["skipped_passes"] > 0,
          "the constellation fleet trained and skipped")
    # the card's share of a chained run of 100 windows: its host time and
    # its kernels' time from the same (kernel-only) trace
    t0 = time.perf_counter()
    fleet.run(100)
    bare_ms = (time.perf_counter() - t0) * 1e3
    host = []

    def framed():
        t = time.perf_counter()
        fleet.run(100)                      # ends in its one host sync
        host.append((time.perf_counter() - t) * 1e3)

    kern = cuda_events(framed, retake=False)
    host_ms = host[-1]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in kern) / 1e3
    n_kern = sum(e.count for e in kern)
    check(0 < busy <= host_ms, f"serving fleet: kernels {busy:.3f} ms in a "
          f"run of {host_ms:.3f} ms (host clock, same trace)")
    print(f"  100 chained windows of the 4 x 256 fleet: {host_ms:.1f} ms "
          f"(host clock, under the kernel-only profiler; {bare_ms:.1f} ms "
          f"unprofiled), kernels {busy:.3f} ms ({n_kern} launches, "
          f"{n_kern / 100:.0f} a window), device idle "
          f"{1 - busy / host_ms:.1%} [{label}]")
    return {n: launches[n] + traffic[n] for n in WRAPPERS}


def serving_clis_11b(label):
    """Phase 11b: ``python -m repro_torch.serve_fleet``, ``python -m
    repro_torch.obs``, the reference's acceptance render ``python -m
    repro_torch.obs render --planes 4 --sats 256 --scenario degraded
    --serve`` and the paper's tables, on the card."""
    t0 = time.perf_counter()
    s = serve_fleet_main.main([])
    check(s["trained_passes"] > 0, f"serve_fleet smoke: {s}")
    t1 = time.perf_counter()
    o = obs_main.main([])
    check(o["serve_events"] == 48 and o["pass_events"] == 32,
          f"obs smoke: {o}")
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        r = obs_main.main(["render", "--planes", "4", "--sats", "256",
                           "--scenario", "degraded", "--serve",
                           "--out", str(Path(td) / "trace.json")])
    check(r["events"] >= 4 * 256 + 4 * 24, f"render: {r}")
    t3 = time.perf_counter()
    tables = paper_tables.run_all(device="cuda")
    top, bot = tables["fig3_top"], tables["fig3_bottom"]
    check(top["W_as_total(/400)"]["savings_pct"] > 90.0,
          f"Fig. 3 savings {top['W_as_total(/400)']['savings_pct']}")
    check(bot["l1"]["e_total"] > bot["l2"]["e_total"] > bot["l3"]["e_total"],
          f"Fig. 3 bottom order {bot}")
    print(f"  serve_fleet smoke {t1 - t0:.3f} s, obs smoke {t2 - t1:.3f} s, "
          f"obs render 4 x 256 degraded + serve {t3 - t2:.3f} s "
          f"({r['events']} events, {r['trace_events']} trace events), "
          f"paper tables {time.perf_counter() - t3:.3f} s (Fig. 3: "
          f"{top['W_as_total(/400)']['savings_pct']:.2f}% saved with W as "
          f"a total; l1 {bot['l1']['e_total']:.4g} > l2 "
          f"{bot['l2']['e_total']:.4g} > l3 {bot['l3']['e_total']:.4g} J "
          f"on the float64 solver on the card) [{label}]")


def check_flash_train(dtype, gen, flush, B=TRAIN_B, S=TRAIN_S, H=H, KV=KV,
                      D=D, causal=True):
    """B2 with its lse at SmolLM-360M's training shape (or another, causal
    or not): the kernel's lse against the plain lse, its time with and
    without lse, the plain backward's time beside SDPA's forward +
    backward, and the autograd Function's gradients against the plain
    path's."""
    dev = torch.device("cuda")
    q, k, v, do = [torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D),
                             (B, H, S, D))]
    o, lse = flash_attn.flash_attention_fwd(q, k, v, causal=causal, lse=True)
    po, plse = flash_attn.flash_attention_lse_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=TOL[dtype], rtol=TOL[dtype])
    lse_err = (lse - plse).abs().max().item()
    o_no_lse = flash_attn.flash_attention_fwd(q, k, v, causal=causal)
    torch.testing.assert_close(o_no_lse.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    del o_no_lse

    def grads(fn):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*ts), ts, do)
    got = grads(lambda *t: ops.flash_attention(*t, causal=causal))
    want = grads(lambda *t: flash_attn.flash_attention_plain(
        *t, causal=causal))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype])
    grad_err = max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))

    kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    sq, sk, sv = (t.detach().requires_grad_() for t in (q, kx, vx))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
        torch.autograd.grad(out, (sq, sk, sv), do)
    b_ms, b_by = bound(*flash_attn.work(q, k, causal=causal, lse=True),
                       dtype)
    bb_ms, bb_by = bound(*flash_attn.bwd_work(q, k, causal=causal), dtype)
    return dict(
        shape=f"train B={B} H={H} KV={KV} S={S} D={D}"
              + ("" if causal else " non-causal") + f" {str(dtype)[6:]}, "
              f"with lse", max_abs_err=(o.float() - po.float()).abs().max()
        .item(), lse_err=lse_err, grad_err=grad_err,
        ms=time_ms(lambda: flash_attn.flash_attention_fwd(
            q, k, v, causal=causal, lse=True), flush=flush),
        ms_no_lse=time_ms(lambda: flash_attn.flash_attention_fwd(
            q, k, v, causal=causal), flush=flush),
        plain_ms=time_ms(lambda: flash_attn.flash_attention_plain(
            q, k, v, causal=causal), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, is_causal=causal), flush=flush),
        bound_ms=b_ms, bound_by=b_by,
        bwd_ms=time_ms(lambda: flash_attn.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal), flush=flush),
        bwd_bound_ms=bb_ms, bwd_bound_by=bb_by,
        sdpa_fwd_bwd_ms=time_ms(sdpa_fwd_bwd, flush=flush))


def check_scan_grads(kind, dtype, gen):
    """B4's or B5's autograd Function at the model's full-width heads:
    the forward against the plain version (phase 3's tolerance, B5 at the
    kernel's chunk) and every gradient against the plain path's (autograd
    through the plain scan at the model's chunk) bit for bit, with the
    time of one backward."""
    dev = torch.device("cuda")
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    S = SCAN_GRAD_S
    if kind == "mamba_scan":
        Hm, P, N = MAMBA_H, MAMBA_P, MAMBA_N
        inputs = (rnd(1, S, Hm, P).to(dtype), F.softplus(rnd(1, S, Hm)),
                  rnd(Hm) * 0.5, rnd(1, S, N).to(dtype),
                  rnd(1, S, N).to(dtype))
        chunk, tol = MAMBA_CHUNK, MAMBA_TOL[dtype]
        state_tol = tol
        fwd_plain = lambda *a: mamba_scan.mamba_chunk_scan_plain(
            *a, chunk=chunk)
        op, plain_path = ops.mamba_scan, mamba_scan.mamba_chunk_scan_plain
        shape = f"B=1 S={S} H={Hm} P={P} N={N} chunk {chunk}"
    else:
        Hx, P = MLSTM_H, MLSTM_P
        inputs = tuple(rnd(1, S, Hx, P).to(dtype) for _ in range(3)) + (
            rnd(1, S, Hx), rnd(1, S, Hx) + 1.0)
        chunk, tol = MLSTM_CHUNK, MLSTM_TOL[dtype]
        state_tol = MLSTM_STATE_TOL
        fwd_plain = lambda *a: mlstm_scan.mlstm_chunk_scan_plain(
            *a, chunk=min(chunk, mlstm_scan.L_MAX))
        op, plain_path = ops.mlstm_scan, mlstm_scan.mlstm_chunk_scan_plain
        shape = f"B=1 S={S} H={Hx} P={P} chunk {chunk} (kernel 64)"
    cots = None

    def grads(fn):
        nonlocal cots
        ts = [t.detach().requires_grad_() for t in inputs]
        outs = flat(fn(*ts, chunk=chunk))
        if cots is None:
            cots = [torch.randn(o.shape, generator=gen, device=dev)
                    .to(o.dtype) for o in outs]
        return outs, torch.autograd.grad(outs, ts, cots)
    n0 = WRAPPERS[kind].launches
    outs, got = grads(op)
    check(WRAPPERS[kind].launches == n0 + 1, f"{kind}: one launch a forward")
    _, want = grads(plain_path)
    for o, w in zip(outs, flat(fwd_plain(*inputs))):
        t = tol if o.dtype == dtype else state_tol
        torch.testing.assert_close(o.float(), w.float(), atol=t, rtol=t)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{kind} {dtype}: a gradient is not finite")
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{kind} {dtype}: the Function's gradients are not the plain "
          f"path's bit for bit")
    ts = [t.detach().requires_grad_() for t in inputs]
    outs = flat(op(*ts, chunk=chunk))
    bwd_ms = time_ms(lambda: torch.autograd.grad(outs, ts, cots,
                                                 retain_graph=True), iters=5)
    return dict(kind=kind, shape=f"{shape} {str(dtype)[6:]}",
                grads=len(got), bwd_ms=bwd_ms,
                nonzero=all(bool((g != 0).any()) for g in got))


def lm_train_12a(label):
    """Phase 12a: full-width SmolLM-360M through ``launch.train`` (batch
    8, seq 512, bf16, remat full, AdamW), exactly 64 B2 launches a step;
    one f32 step's loss and gradients, kernel path against plain path;
    steps/s and the card's share from one trace, of the step
    ``launch.train`` runs (the (1, 1) mesh), beside the mesh-less step."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = launch_train.main([
        "--steps", str(LM_TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq",
        str(TRAIN_S), "--remat", "full", "--lr", "3e-4", "--log-every", "5"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in WRAPPERS.items()}
    check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
          f"launch.train losses {losses}")
    check(losses[-1] < losses[0], f"loss fell: {losses[0]} -> {losses[-1]}")
    check(launches["flash_attn_fwd"] == LM_B2_PER_STEP * LM_TRAIN_STEPS
          and all(launches[n] == 0 for n in launches if n != "flash_attn_fwd"),
          f"launches {launches}: want {LM_B2_PER_STEP} B2 a step, no other")

    cfg = configs.get("smollm_360m")
    shards = TokenShards(vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in shards.batch_at(0, 0).items()}
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(3))
    f32 = TrainConfig(act_dtype=torch.float32, remat="full")
    lk, _, gk = loss_and_grads(cfg, f32, params, batch)
    lp, _, gp = with_plain_ops(lambda: loss_and_grads(cfg, f32, params, batch))
    lk, lp = float(lk), float(lp)
    check(abs(lk - lp) <= LM_STEP_LOSS_RTOL * abs(lp), ("12a f32 loss", lk, lp))
    g_err = 0.0
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)
        g_err = max(g_err, (a - b).abs().max().item())
    del gk, gp

    # steps/s and the card's share of the step the CLI runs (the (1, 1)
    # mesh of launch.train's one rank), timed in turns with the mesh-less
    # step on the same batch: one, CLI, CLI, one, LM_TIMED steps each
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4, warmup_steps=10,
                                         total_steps=LM_TRAIN_STEPS))
    with h100.process_group("cuda") as dev:
        mesh = h100.make_host_mesh(1, dev)
        cli, _, _, init_cli = make_train_step(cfg, mesh, ShardingRules(),
                                              tcfg, device=dev)
        one, _, _, init_one = make_train_step(cfg, tcfg=tcfg, device=dev)
        states = {"cli": init_cli(0), "one": init_one(0)}
        steps = {"cli": cli, "one": one}
        timed = {"cli": [], "one": []}
        for name in ("one", "cli", "cli", "one"):
            step, state = steps[name], states[name]
            if not timed[name]:                         # warm-up
                state, m = step(state, batch)
                float(m["loss"])
            parallel.COLLECTIVES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LM_TIMED):
                state, m = step(state, batch)
                float(m["loss"])
            timed[name].append((time.perf_counter() - t0) / LM_TIMED * 1e3)
            calls = sum(parallel.COLLECTIVES.values())
            check((calls > 0) == (name == "cli"), f"12a: {calls} collective "
                  f"calls in {LM_TIMED} {name} steps")
            states[name] = state
        del states["one"]
        state, step = states.pop("cli"), cli
        step_ms, one_ms = min(timed["cli"]), min(timed["one"])
        host = []

        def framed():
            nonlocal state
            t = time.perf_counter()
            for _ in range(2):
                state, m = step(state, batch)
                float(m["loss"])
            host.append((time.perf_counter() - t) * 1e3 / 2)
        kern = cuda_events(framed, retake=False)
        parallel.COLLECTIVES.clear()
        state, m = step(state, batch)
        float(m["loss"])
        calls = dict(parallel.COLLECTIVES)
        del state
    busy = sum(getattr(e, "self_device_time_total", 0) for e in kern) / 2e3
    check(0 < busy <= host[-1], f"12a: card {busy} ms in {host[-1]} ms")
    tok = TRAIN_B * TRAIN_S
    print(f"train smollm_360m (full width, {cfg.param_count() / 1e6:.1f}M "
          f"params) batch {TRAIN_B} seq {TRAIN_S} bf16 remat full AdamW "
          f"[{label}]")
    print(f"  launch.train: {LM_TRAIN_STEPS} steps in {wall:.2f} s incl. "
          f"init and the first step; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {launches} "
          f"({launches['flash_attn_fwd'] // LM_TRAIN_STEPS} B2 a step)")
    print(f"  step (launch.train's: the (1, 1) mesh, {sum(calls.values())} "
          f"collective calls {calls}): {step_ms:.2f} ms = "
          f"{1e3 / step_ms:.3f} steps/s, {tok * 1e3 / step_ms:.0f} tokens/s "
          f"(host clock, ends in a sync; the faster of 2 rounds of "
          f"{LM_TIMED}); the mesh-less step in turns with it {one_ms:.2f} "
          f"ms ({step_ms / one_ms - 1:+.1%}); rounds one, CLI, CLI, one: "
          f"{timed['one'][0]:.2f}, {timed['cli'][0]:.2f}, "
          f"{timed['cli'][1]:.2f}, {timed['one'][1]:.2f} ms [{label}]")
    print(f"  "
          f"traced: host {host[-1]:.2f} ms, card {busy:.2f} ms a step, "
          f"device idle {1 - busy / host[-1]:.1%} (host and card from one "
          f"kernel-only trace; against the unprofiled step "
          f"{max(0.0, 1 - busy / step_ms):.1%}) [{label}]")
    print(f"  one f32 step, kernel vs plain path: loss {lk:.7f} vs "
          f"{lp:.7f}, gradients max abs diff {g_err:.3e}")
    top = sorted(kern, key=lambda e: getattr(e, "self_device_time_total", 0),
                 reverse=True)[:6]
    for e in top:
        print(f"    {getattr(e, 'self_device_time_total', 0) / 2e3:8.3f} ms "
              f"a step {e.count / 2:6.1f}x  {e.key[:80]}")
    return launches


def lm_split_ring_12b(label):
    """Phase 12b: full-width SmolLM-360M split at unit 16 through the
    constellation ring (AdamW, int8 boundary): 2 B1 and 32 B2 launches a
    SL step, no wrapper copy, the boundary payload, one SL step kernel
    path against plain path, SL steps/s."""
    cfg = configs.get("smollm_360m")
    adapter = sl_step.lm_adapter(cfg, cut_units=LM_CUT, seq_len=TRAIN_S)
    shards = TokenShards(vocab=cfg.vocab, seq_len=TRAIN_S,
                         batch=LM_RING_BATCH, n_shards=25)
    sim = ConstellationSim(
        adapter, PassBudget(), shards.batch_at,
        ConstellationConfig(n_passes=LM_RING_PASSES, optimizer="adamw",
                            lr=3e-4, quantize_boundary=True,
                            max_steps_per_pass=LM_RING_STEPS),
        device="cuda")
    for fn in WRAPPERS.values():
        fn.launches = 0
    split_quant.quantize_rows.launches = 0
    split_quant.copies = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in WRAPPERS.items()}
    steps = int(sim.state.step)
    check(steps > 0 and all(r.loss is not None and np.isfinite(r.loss)
                            for r in records if r.action != "skipped"),
          f"12b: {[(r.action, r.loss) for r in records]}")
    check(launches["split_quant"] == 2 * steps
          and launches["flash_attn_fwd"] == LM_B2_PER_SL_STEP * steps
          and launches["decode_attn"] == launches["mamba_scan"]
          == launches["mlstm_scan"] == 0,
          f"12b launches {launches} for {steps} SL steps")
    check((split_quant.quantize_rows.launches, split_quant.copies) == (0, 0),
          "12b: no quantize_rows launch and no wrapper copy")
    batch = shards.batch_at(0, 0)
    bits = sl_step.boundary_bits(adapter, batch, True)
    check(bits == LM_RING_BATCH * TRAIN_S * cfg.d_model * 8,
          f"boundary payload {bits} bits")
    step = sl_step.make_sl_step(adapter, quantize_boundary=True)
    pa, pb = sim.state.params_a, sim.state.params_b
    rk = step(pa, pb, batch)
    kernel_quant = split_quant.quantize_dequantize
    split_quant.quantize_dequantize = split_quant.quantize_dequantize_plain
    try:
        rp = with_plain_ops(lambda: step(pa, pb, batch))
    finally:
        split_quant.quantize_dequantize = kernel_quant
    lk, lp = float(rk.loss), float(rp.loss)
    check(abs(lk - lp) <= LM_STEP_LOSS_RTOL * abs(lp), ("12b loss", lk, lp))
    g_err = 0.0
    for tk, tp in ((rk.grads_a, rp.grads_a), (rk.grads_b, rp.grads_b)):
        for a, b in zip(tree_leaves(tk), tree_leaves(tp)):
            torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)
            g_err = max(g_err, (a - b).abs().max().item())
    parts = boundary_bitwise(
        adapter, sim.state,
        {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()},
        shapes=LM_BOUNDARY_SHAPES)
    print(f"split ring smollm_360m cut at unit {LM_CUT}, batch "
          f"{LM_RING_BATCH} seq {TRAIN_S} f32, AdamW, int8 boundary, "
          f"{LM_RING_PASSES} passes [{label}]")
    print(f"  actions {[r.action for r in records]}; losses "
          f"{[round(r.loss, 4) for r in records if r.loss is not None]}")
    print(f"  {steps} SL steps in {wall:.3f} s = {steps / wall:.3f} SL "
          f"steps/s incl. planning; launches {launches}; boundary {bits} "
          f"bits ({bits // (LM_RING_BATCH * TRAIN_S)} a token); one step "
          f"kernel {lk:.7f} vs plain {lp:.7f}, gradients max abs diff "
          f"{g_err:.3e} [{label}]")
    print(f"  B1 bit for bit against the plain version, both entries, no "
          f"copy, on the path's own boundary: {'; '.join(parts)}")
    return launches


def smoke_train_12c(label):
    """Phase 12c: the Zamba2, xLSTM, Mixtral and Phi-3.5-MoE smoke configs
    on the card (B4 / B5 and B2 with gradients; the MoE configs under both
    dispatch layouts), under full and selective (dots) remat: each
    kernel launched twice a layer (the forward and the recompute), every
    projection weight (the MoE router and experts included) with a
    nonzero gradient, equal to the same loss and gradient on the CPU;
    then one train step on the card."""
    proj = ("wq", "wk", "wv", "wo", "wi", "w_in", "w_bc", "w_dt", "w_out",
            "w_qkv", "w_if", "w_x", "w_h", "router")
    kernel_of = {"zamba2_1_2b": "mamba_scan", "xlstm_1_3b": "mlstm_scan",
                 "mixtral_8x7b": "flash_attn_fwd",
                 "phi35_moe": "flash_attn_fwd",
                 "whisper_small": "flash_attn_fwd"}
    total = {n: 0 for n in WRAPPERS}
    for arch, want in kernel_of.items():
        cfg = configs.get_smoke(arch)
        params = lm.init(cfg, torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (2, 129), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        frames = {}
        if cfg.enc_dec:            # Whisper: seeded encoder frames
            frames["enc_frames"] = torch.randn(
                (2, cfg.frontend_len, cfg.d_model),
                generator=torch.Generator().manual_seed(2)) * 0.1
            batch.update(frames)
        on_card = map_tree(lambda t: t.to("cuda"), params)
        card_batch = {k: v.cuda() for k, v in batch.items()}
        dispatches = ("global", "batch_local") if cfg.n_experts else \
            ("global",)
        for remat, dispatch in [(r, m) for m in dispatches
                                for r in ("full", "dots")]:
            tcfg = TrainConfig(act_dtype=torch.float32, remat=remat,
                               moe_dispatch=dispatch)
            lp, _, gp = loss_and_grads(cfg, tcfg, params, batch)
            for fn in WRAPPERS.values():
                fn.launches = 0
            with torch.no_grad():
                lm.loss(cfg, on_card, card_batch["tokens"],
                        card_batch["labels"],
                        ctx=Ctx(cfg=cfg, act_dtype=torch.float32,
                                moe_dispatch=dispatch),
                        enc_frames=card_batch.get("enc_frames"),
                        remat="none")
            once = {n: fn.launches for n, fn in WRAPPERS.items()}
            lc, _, gc = loss_and_grads(cfg, tcfg, on_card, card_batch)
            launches = {n: fn.launches - once[n] for n, fn in WRAPPERS.items()}
            # remat recomputes the decoder's launches; the encoder's (one
            # B2 a layer) are not recomputed, as in the reference
            enc = {want: cfg.n_enc_layers} if cfg.enc_dec else {}
            check(once[want] > 0 and once["decode_attn"] == 0
                  and launches == {n: 2 * c - enc.get(n, 0)
                                   for n, c in once.items()},
                  f"12c {arch} remat {remat}: forward {once}, loss and "
                  f"gradient {launches}: want twice the forward's (the "
                  f"encoder's once)")
            check(abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp)),
                  f"12c {arch} remat {remat} {dispatch} loss card "
                  f"{float(lc)} cpu {float(lp)}")
            cpu = dict(tree_flatten_with_names(gp))
            n_proj, g_err = 0, 0.0
            for name, g in tree_flatten_with_names(gc):
                if name.rsplit(".", 1)[-1] in proj:
                    check(bool((g != 0).any()), f"12c {arch}: {name} has no "
                          "gradient on the card")
                    n_proj += 1
                torch.testing.assert_close(g.cpu(), cpu[name], atol=5e-4,
                                           rtol=5e-4)
                g_err = max(g_err, (g.cpu() - cpu[name]).abs().max().item())
            print(f"  12c {arch} smoke, remat {remat}"
                  + (f", moe_dispatch {dispatch}" if cfg.n_experts else "")
                  + f": loss card "
                  f"{float(lc):.6f} cpu {float(lp):.6f}; {n_proj} projection "
                  f"weights, all nonzero, max abs diff to the CPU "
                  f"{g_err:.3e}; launches {launches} (forward only {once}) "
                  f"[{label}]")
            for n in total:
                total[n] += launches[n]
        for fn in WRAPPERS.values():
            fn.launches = 0
        step, _, _, _ = make_train_step(
            cfg, tcfg=TrainConfig(act_dtype=torch.float32, remat="full"),
            device="cuda")
        state, metrics = step(TrainState(on_card, adamw_init(on_card), None),
                              batch)
        launches = {n: fn.launches for n, fn in WRAPPERS.items()}
        check(np.isfinite(float(metrics["loss"])) and launches[want] > 0,
              f"12c {arch} train_step: loss {metrics['loss']}, {launches}")
        for n in total:
            total[n] += launches[n]
    return total


def whisper_serve_14a(label):
    """Phase 14a: Whisper-small at its published widths (nothing cut),
    seeded weights cast once to bf16 as the engines cast them: 8 requests
    of 1,500 stub frames and 64-token prompts through make_prefill_step
    (exactly 36 B2), cache_from_prefill at s_max 448, 32 greedy steps of
    make_decode_step (exactly 24 B3 a step), the cross cache bit for bit
    unchanged; every B2 and B3 call of one prefill and one step against
    its plain version; f32 prefill logits kernel vs plain; f32
    prefill-then-decode against the full forward over 8 steps. Prints the
    prefill's time and its encoder's share, the decode step's time and
    rate, one trace of each and the peak memory. Returns the launches."""
    t_phase = time.perf_counter()
    cfg = configs.get("whisper_small")
    check((cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.frontend_len)
          == (12, 12, 768, WHISPER_H, D, 3072, 51865, WHISPER_FRAMES),
          "whisper-small published widths")
    B, P = WHISPER_B, WHISPER_PROMPT
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9      # by earlier phases
    torch.cuda.reset_peak_memory_stats()
    params32 = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    params = _cast_matmul_weights(params32, torch.bfloat16, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params32))
    frames = torch.randn((B, WHISPER_FRAMES, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1)) * 0.1
    rng = np.random.default_rng(2)
    seq = torch.tensor(rng.integers(0, cfg.vocab, (B, P + WHISPER_PARITY_STEPS))
                       .astype(np.int32), device="cuda")
    batch = {"tokens": seq[:, :P], "enc_frames": frames}
    prefill, _ = make_prefill_step(cfg, act_dtype=torch.bfloat16)
    serve_step, _, _, _ = make_decode_step(
        cfg, batch=B, s_max=WHISPER_S_MAX, act_dtype=torch.bfloat16,
        device="cuda")
    counts = lambda: {n: w.launches for n, w in WRAPPERS.items()}

    def zero():
        for w in WRAPPERS.values():
            w.launches = 0

    def timed_prefill():
        t0 = time.perf_counter()
        out = prefill(params, batch)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    timed_prefill()                                   # warm-up
    zero()
    (last, caches), _ = timed_prefill()
    p_launches = counts()
    check(p_launches == {**dict.fromkeys(WRAPPERS, 0),
                         "flash_attn_fwd": WHISPER_B2_PER_PREFILL},
          f"14a prefill launches {p_launches}")
    prefill_ms = statistics.median(timed_prefill()[1] for _ in range(3))
    ectx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.bfloat16)

    def encoder():
        t0 = time.perf_counter()
        with torch.no_grad():
            lm._run_encoder(cfg, params, frames, ectx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    encoder()
    enc_ms = statistics.median(encoder() for _ in range(3))

    cache = lm.cache_from_prefill(cfg, caches, WHISPER_S_MAX, torch.bfloat16)
    del caches
    cross0 = map_tree(torch.clone, {k: b["cross"] for k, b in cache.items()})
    check(tuple(cache["0:attn"]["cross"]["k"].shape)
          == (cfg.n_units, B, WHISPER_H, WHISPER_FRAMES, D)
          and tuple(cache["0:attn"]["attn"]["k"].shape)
          == (cfg.n_units, B, WHISPER_H, WHISPER_S_MAX, D),
          "14a decode cache shapes")
    tok = last.argmax(-1).to(torch.int32)
    generated, step_ms = [tok], []
    zero()
    for t in range(WHISPER_STEPS):
        pos = torch.full((B,), P + t, dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        logits, cache = serve_step(params, cache, tok, pos)
        tok = logits.argmax(-1).to(torch.int32)
        host_tok = tok.cpu()                          # the greedy read-back
        step_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(host_tok)
        check(bool(torch.isfinite(logits).all()), f"14a step {t} logits")
    d_launches = counts()
    check(d_launches == {**dict.fromkeys(WRAPPERS, 0),
                         "decode_attn": WHISPER_B3_PER_STEP * WHISPER_STEPS},
          f"14a decode launches {d_launches}")
    toks = torch.cat([g.cpu() for g in generated], dim=1)
    check(tuple(toks.shape) == (B, WHISPER_STEPS + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "14a greedy tokens")
    check(all(torch.equal(cache[k]["cross"][kk], cross0[k][kk])
              for k in cross0 for kk in ("k", "v")),
          "14a: the cross cache changed during decode")

    # every B2 call of one prefill and every B3 call of one step against
    # its plain version on the same inputs (phase 3's tolerance)
    _, p_calls = with_checked_ops(lambda: prefill(params, batch))
    pos = torch.full((B,), P + WHISPER_STEPS, dtype=torch.int32,
                     device="cuda")
    _, d_calls = with_checked_ops(lambda: serve_step(
        params, map_tree(torch.clone, cache), tok, pos))
    check({n: c[0] for n, c in p_calls.items()}
          == {"flash_attention": WHISPER_B2_PER_PREFILL}
          and {n: c[0] for n, c in d_calls.items()}
          == {"decode_attention": WHISPER_B3_PER_STEP},
          f"14a checked calls {p_calls} {d_calls}")

    # one trace of a decode step and of a prefill: card, host, idle
    cache_p = map_tree(torch.clone, cache)
    profile_calls(lambda: serve_step(params, cache_p, tok, pos)[0]
                  .argmax(-1).cpu(), 5, "whisper decode steps (batch 8)",
                  label)
    del cache_p
    profile_calls(lambda: prefill(params, batch)[0].argmax(-1).cpu(), 3,
                  f"whisper prefills (batch {B}: {WHISPER_FRAMES} frames, "
                  f"{P} tokens)", label)
    del cache, params
    torch.cuda.empty_cache()

    # f32: prefill logits kernel vs plain, and prefill-then-decode against
    # the full forward (kernel path)
    pctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    with torch.no_grad():
        pk, _, caches = lm.forward(cfg, params32, seq[:, :P], ctx=pctx,
                                   enc_frames=frames)
        pp, _, _ = with_plain_ops(lambda: lm.forward(
            cfg, params32, seq[:, :P], ctx=pctx, enc_frames=frames))
        p_err, p_max, p_agree = logits_close(pk, pp, "14a f32 prefill",
                                             PREFILL_F32_TOL_OF_MAX)
        del pp
        full, _, _ = lm.forward(cfg, params32, seq, enc_frames=frames,
                                ctx=dataclasses.replace(pctx, mode="train"))
        cache = lm.cache_from_prefill(cfg, caches, WHISPER_S_MAX,
                                      torch.float32)
        del caches
        dctx = dataclasses.replace(pctx, mode="decode")
        par_err = 0.0
        for t in range(P, P + WHISPER_PARITY_STEPS):
            pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
            lg, cache = lm.decode_step(cfg, params32, cache, seq[:, t:t + 1],
                                       pos, ctx=dctx)
            want = full[:, t]
            err = (lg[:, 0] - want).abs()
            check(bool((err <= DECODE_PARITY_TOL
                        + DECODE_PARITY_TOL * want.abs()).all()),
                  f"14a f32 prefill-then-decode at {t}: {err.max().item()}")
            par_err = max(par_err, err.max().item())
    del cache, full, params32
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    med_step = statistics.median(step_ms)
    print(f"whisper-small (published widths, nothing cut: 12 + 12 layers, "
          f"d 768, 12 heads of 64, vocab 51,865; {n_params / 1e6:.1f}M "
          f"params), bf16, {B} requests of {WHISPER_FRAMES} frames + {P} "
          f"tokens, s_max {WHISPER_S_MAX}, {WHISPER_STEPS} greedy steps "
          f"[{label}]")
    print(f"  prefill {prefill_ms:.2f} ms (median of 3, host clock to a "
          f"sync), encoder alone {enc_ms:.2f} ms = {enc_ms / prefill_ms:.1%} "
          f"of it; launches {p_launches}")
    print(f"  decode step median {med_step:.2f} ms over {WHISPER_STEPS} "
          f"steps = {B * 1e3 / med_step:.1f} tok/s ({B} rows); launches "
          f"{d_launches} ({WHISPER_B3_PER_STEP} B3 a step); cross cache "
          f"unchanged bit for bit")
    print(f"  every call vs plain (calls, err, max |plain|): prefill "
          + ", ".join(f"{n} {c}x ({e:.3e}, {t:.3e})"
                      for n, (c, e, t) in p_calls.items())
          + "; decode step " + ", ".join(
              f"{n} {c}x ({e:.3e}, {t:.3e})" for n, (c, e, t) in
              d_calls.items()))
    print(f"  f32 prefill logits kernel vs plain max abs err {p_err:.3e} of "
          f"{p_max:.3e} (tol {PREFILL_F32_TOL_OF_MAX:g} of max; argmax equal "
          f"{p_agree:.1%}); f32 prefill-then-decode vs the full forward, "
          f"{WHISPER_PARITY_STEPS} steps: max abs err {par_err:.3e} (tol "
          f"{DECODE_PARITY_TOL:g} + {DECODE_PARITY_TOL:g} |logit|)")
    print(f"  peak device memory (max_memory_allocated) {peak:.2f} GB, of "
          f"which {held:.2f} GB held before the phase; 14a "
          f"{time.perf_counter() - t_phase:.1f} s [{label}]")
    return {n: p_launches[n] + d_launches[n] for n in WRAPPERS}


def whisper_train_14b(label):
    """Phase 14b: Whisper-small at its published widths through
    ``launch.train`` (batch 4 x 128, bf16, remat full, AdamW, zero
    encoder frames as the reference hands its step): finite, falling
    losses, exactly 60 B2 a step and no other kernel; one f32 step's loss
    and gradients on seeded frames, kernel path against plain path, every
    projection weight's gradient nonzero; the step's time."""
    t_phase = time.perf_counter()
    for fn in WRAPPERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = launch_train.main([
        "--arch", "whisper_small", "--steps", str(WHISPER_TRAIN_STEPS),
        "--batch", str(WHISPER_TRAIN_B), "--seq", str(WHISPER_TRAIN_S),
        "--remat", "full", "--lr", "3e-4", "--log-every", "5"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in WRAPPERS.items()}
    check(len(losses) == WHISPER_TRAIN_STEPS and all(np.isfinite(losses)),
          f"14b losses {losses}")
    check(losses[-1] < losses[0], f"14b loss fell: {losses[0]} -> "
          f"{losses[-1]}")
    check(launches == {**dict.fromkeys(WRAPPERS, 0), "flash_attn_fwd":
                       WHISPER_B2_PER_TRAIN_STEP * WHISPER_TRAIN_STEPS},
          f"14b launches {launches}: want {WHISPER_B2_PER_TRAIN_STEP} B2 a "
          f"step, no other")

    cfg = configs.get("whisper_small")
    shards = TokenShards(vocab=cfg.vocab, seq_len=WHISPER_TRAIN_S,
                         batch=WHISPER_TRAIN_B)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in shards.batch_at(0, 0).items()}
    batch["enc_frames"] = torch.randn(
        (WHISPER_TRAIN_B, WHISPER_FRAMES, cfg.d_model), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(4)) * 0.1
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(3))
    f32 = TrainConfig(act_dtype=torch.float32, remat="full")
    lk, _, gk = loss_and_grads(cfg, f32, params, batch)
    lp, _, gp = with_plain_ops(lambda: loss_and_grads(cfg, f32, params, batch))
    lk, lp = float(lk), float(lp)
    check(abs(lk - lp) <= LM_STEP_LOSS_RTOL * abs(lp), ("14b f32 loss", lk, lp))
    g_err, n_proj = 0.0, 0
    plain = dict(tree_flatten_with_names(gp))
    for name, g in tree_flatten_with_names(gk):
        torch.testing.assert_close(g, plain[name], atol=5e-4, rtol=5e-4)
        g_err = max(g_err, (g - plain[name]).abs().max().item())
        if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo", "wi"):
            # stacked leaves: every layer's slice
            check(bool((g != 0).flatten(1).any(1).all()),
                  f"14b: a layer of {name} has no gradient")
            n_proj += 1
    check(n_proj == 6 + 10, f"14b: {n_proj} stacked projection weights "
          f"(the encoder's 6, the decoder's 10 with cross-attention's 4)")
    del gk, gp, plain

    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4, warmup_steps=10,
                                         total_steps=WHISPER_TRAIN_STEPS))
    step, _, _, init_state = make_train_step(cfg, tcfg=tcfg, device="cuda")
    state = init_state(0)
    bf_batch = dict(batch, enc_frames=batch["enc_frames"].bfloat16())
    state, _ = step(state, bf_batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = step(state, bf_batch)
        float(m["loss"])
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    del state
    torch.cuda.empty_cache()
    tok = WHISPER_TRAIN_B * WHISPER_TRAIN_S
    print(f"train whisper-small (published widths, {cfg.param_count() / 1e6:.1f}"
          f"M params) batch {WHISPER_TRAIN_B} x {WHISPER_TRAIN_S} tokens + "
          f"{WHISPER_FRAMES} frames, bf16, remat full, AdamW [{label}]")
    print(f"  launch.train: {WHISPER_TRAIN_STEPS} steps in {wall:.2f} s incl. "
          f"init and the first step; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {launches} "
          f"({launches['flash_attn_fwd'] // WHISPER_TRAIN_STEPS} B2 a step: "
          f"12 encoder, 24 decoder, 24 recomputed)")
    print(f"  step {step_ms:.2f} ms = {tok * 1e3 / step_ms:.0f} decoder "
          f"tokens/s (host clock, ends in a sync); one f32 step kernel vs "
          f"plain: loss {lk:.7f} vs {lp:.7f}, gradients max abs diff "
          f"{g_err:.3e}, {n_proj} stacked projection weights nonzero in every "
          f"layer; 14b "
          f"{time.perf_counter() - t_phase:.1f} s [{label}]")
    return launches


def examples_14c(label):
    """Phase 14c: the four example ports on the card at the reference
    examples' own sizes, each one's launches and wall time."""
    total = dict.fromkeys(WRAPPERS, 0)
    runs = [("quickstart", quickstart.main, []),
            ("constellation_online_learning",
             constellation_online_learning.main, []),
            ("serve_batched", serve_batched.main, ["--arch", "smollm_360m"]),
            ("isl_exchange", isl_exchange.main, [])]
    for name, fn, argv in runs:
        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in WRAPPERS.items()}
        if name == "quickstart":
            check(len(out["steps"]) == 3
                  and all(np.isfinite(l) for l, _ in out["steps"])
                  and launches["split_quant"] == 2 * 3,
                  f"14c quickstart {out['steps']} {launches}")
        elif name == "constellation_online_learning":
            steps = int(out.state.step)
            check(len(out.records) == 25 and steps > 0
                  and launches["split_quant"] == 2 * steps
                  and out.summary()["trained"] > 0,
                  f"14c ring: {out.summary()} {launches}")
        elif name == "serve_batched":
            check(sorted(out) == list(range(6))
                  and all(len(t) == 10 for t in out.values())
                  and launches["flash_attn_fwd"] == 2 * 6
                  and launches["decode_attn"] > 0,
                  f"14c serve_batched {launches}")
        else:
            sync, gossip = out.values()
            check(sync["wire_bits"] > 10 * gossip["wire_bits"] > 0
                  and gossip["contacts"] > 0,
                  f"14c isl_exchange {out}")
        print(f"  14c {name}: {wall:.2f} s, launches {launches} [{label}]")
        for n in total:
            total[n] += launches[n]
    return total


def mixtral_13a(label):
    """Phase 13a: Mixtral-8x7B served split at published widths, 16 of 32
    layers, bf16 weights at rest (serve_full_width's checks), with its
    peak device memory. Returns the kernels' launches."""
    torch.cuda.reset_peak_memory_stats()
    launches, split, params = serve_full_width("mixtral_8x7b", label)
    print(f"  peak device memory (max_memory_allocated) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; the bf16 "
          f"weights {sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f} GB, shared by "
          f"the split and unsplit engines [{label}]")
    del split, params
    gc.collect()          # the engines' timed wrappers hold them in cycles
    torch.cuda.empty_cache()
    return launches


def two_unit_13b(arch, label):
    """Phase 13b: one of Llama-3-8B, InternLM2-20B, Qwen2-VL-7B and
    Phi-3.5-MoE at its published widths, 2 units (f32 weights), split at
    unit 1: 8 prefills and 8 decode steps of the split engine in bf16
    with every kernel call held to its plain version, exact B2 and B3
    counts (2 a prefill, 2 a decode step), split == unsplit tokens; the
    f32 prefill's and one f32 split decode step's logits, kernel path
    against plain. Qwen2-VL also runs a 256-patch vision prefix (M-RoPE
    grid ids) kernel against plain, and shows that text-only M-RoPE is
    RoPE while the grid ids are not. Returns the kernels' launches."""
    t0 = time.perf_counter()
    cfg = configs.get(arch)
    d, vocab, group = TWO_UNIT[arch]
    check((cfg.d_model, cfg.vocab, cfg.n_heads // cfg.n_kv_heads,
           cfg.head_dim) == (d, vocab, group, D128), f"{arch} widths")
    published = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=2 * len(cfg.pattern_unit()))
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(1)
    plens = rng.integers(32, 513, TWO_UNIT_REQUESTS)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in plens]
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=TWO_UNIT_STEPS)
                    for i, p in enumerate(prompts)]
    split = SplitDecodeEngine(cfg, params, cut_units=1, **SERVE_KW)
    n_calls = {"prefill": 0, "step": 0}

    def counted(what, fn):
        def run(*a):
            n_calls[what] += 1
            return fn(*a)
        return run
    split._prefill = counted("prefill", split._prefill)
    split._step = counted("step", split._step)
    for w in WRAPPERS.values():
        w.launches = 0
    with torch.no_grad():
        out, calls = with_checked_ops(lambda: split.submit_and_run(reqs()))
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    want = {**dict.fromkeys(WRAPPERS, 0),
            "flash_attn_fwd": 2 * TWO_UNIT_REQUESTS,
            "decode_attn": 2 * TWO_UNIT_STEPS}
    check(n_calls == {"prefill": TWO_UNIT_REQUESTS,
                      "step": TWO_UNIT_STEPS} and launches == want,
          f"13b {arch}: calls {n_calls}, launches {launches} != {want}")
    check({n: c[0] for n, c in calls.items()} == {
        "flash_attention": want["flash_attn_fwd"],
        "decode_attention": want["decode_attn"]},
        f"13b {arch}: checked calls {calls}")
    check(all(len(t) == TWO_UNIT_STEPS for t in out.values()),
          f"13b {arch}: tokens")
    unsplit = DecodeEngine(cfg, params, **SERVE_KW).submit_and_run(reqs())
    check(unsplit == out, f"13b {arch}: split and unsplit tokens differ")
    del split

    # f32 logits: the longest prompt's prefill, then one split decode step
    # from its cache, kernel path against plain path
    longest = torch.tensor(prompts[int(np.argmax(plens))][None, :],
                           device="cuda")
    pctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    dctx = Ctx(cfg=cfg, mode="decode", act_dtype=torch.float32)
    pa, pb = lm.split_serve_params(cfg, params, 1)
    with torch.no_grad():
        pk, _, caches = lm.forward(cfg, params, longest, ctx=pctx)
        pp, _, _ = with_plain_ops(lambda: lm.forward(cfg, params, longest,
                                                     ctx=pctx))
        cache = lm.cache_from_prefill(cfg, caches, SERVE_KW["s_max"],
                                      torch.float32)
        cache0 = map_tree(torch.clone, cache)
        tok = pk[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.tensor([longest.shape[1]], device="cuda")
        dk, _, _ = lm.decode_step_split(cfg, pa, pb, cache, tok, pos,
                                        ctx=dctx)
        dp, _, _ = with_plain_ops(lambda: lm.decode_step_split(
            cfg, pa, pb, cache0, tok, pos, ctx=dctx))
    del caches, cache, cache0
    p_err, p_max, p_agree = logits_close(pk, pp, f"13b {arch} f32 prefill",
                                         PREFILL_F32_TOL_OF_MAX)
    d_err, d_max, _ = logits_close(dk, dp, f"13b {arch} f32 decode",
                                   PREFILL_F32_TOL_OF_MAX)
    print(f"  13b {arch}: published widths (d {d}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {D128}, group {group}, vocab {vocab}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts
             else "") + f"), reduced: n_layers {published} → "
          f"{cfg.n_layers}, f32 weights "
          f"{sum(t.numel() for t in tree_leaves(params)) * 4 / 1e9:.2f} GB; "
          f"split@1 bf16: {TWO_UNIT_REQUESTS} prefills (prompts "
          f"{plens.min()}-{plens.max()}) and {TWO_UNIT_STEPS} decode "
          f"steps, launches {launches}, every call vs plain (calls, err, "
          f"max |plain|) " + ", ".join(
              f"{n} {c}x ({e:.3e}, {t:.3e})" for n, (c, e, t) in
              calls.items()) + f"; split tokens == unsplit; f32 logits "
          f"kernel vs plain: prefill of {longest.shape[1]} max abs err "
          f"{p_err:.3e} of {p_max:.3e} (argmax equal {p_agree:.1%}), "
          f"split decode step {d_err:.3e} of {d_max:.3e} (tol "
          f"{PREFILL_F32_TOL_OF_MAX:g} of max) [{label}]")

    if cfg.mrope:
        # a 256-patch vision prefix: the grid ids of M-RoPE, kernel vs plain
        F_ = cfg.frontend_len
        toks = torch.tensor(rng.integers(0, vocab, (1, QWEN_PREFIX_S))
                            .astype(np.int32), device="cuda")
        front = torch.randn((1, F_, d), generator=torch.Generator(
            device="cuda").manual_seed(2), device="cuda") * 0.02
        tctx = Ctx(cfg=cfg, act_dtype=torch.float32)
        rope_cfg = dataclasses.replace(cfg, mrope=False)
        with torch.no_grad():
            vk, _, _ = lm.forward(cfg, params, toks, ctx=tctx,
                                  frontend_embed=front)
            vp, _, _ = with_plain_ops(lambda: lm.forward(
                cfg, params, toks, ctx=tctx, frontend_embed=front))
            vr, _, _ = lm.forward(rope_cfg, params, toks, ctx=tctx,
                                  frontend_embed=front)
            tk, _, _ = lm.forward(cfg, params, toks, ctx=tctx)
            tr, _, _ = lm.forward(rope_cfg, params, toks, ctx=tctx)
        v_err, v_max, _ = logits_close(vk, vp, "13b vision prefix f32",
                                       PREFILL_F32_TOL_OF_MAX)
        grid = (vk - vr).abs().max().item()
        check(grid > 1e-3 * v_max, f"13b: M-RoPE grid ids change nothing "
              f"({grid})")
        check(torch.equal(tk, tr), "13b: text-only M-RoPE is not RoPE")
        print(f"  13b {arch}: {F_}-patch vision prefix + "
              f"{QWEN_PREFIX_S - F_} tokens (grid {int(math.isqrt(F_))} x "
              f"{int(math.isqrt(F_))}), f32 logits kernel vs plain max abs "
              f"err {v_err:.3e} of {v_max:.3e}; M-RoPE grid ids vs plain "
              f"RoPE on the same prefix {grid:.3e}; text-only M-RoPE == "
              f"RoPE bit for bit [{label}]")
    del params
    torch.cuda.empty_cache()
    print(f"  13b {arch}: {time.perf_counter() - t0:.1f} s [{label}]")
    return launches


def census_vs_dry_run(cfg, shape, tcfg, params, batch, label):
    """Phase 15: one step of ``shape`` under the census on the card
    against the dry run on meta at the same shape and config: FLOPs,
    bytes, op counts and each kernel's launches equal (and the wrappers'
    own counters moved by as much: the kernels ran); the census's peak
    beside the step's ``max_memory_allocated`` rise; the step's median
    time against the dry run's ``bound_s``. Returns the launches."""
    run, args = dryrun.make_step(cfg, shape, tcfg, params=params,
                                 batch=batch, device="cuda")
    run(*args)                                          # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(P15_TIMED[shape.kind]):
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)

    for fn in WRAPPERS.values():
        fn.launches = 0
    card = Census(device="cuda")
    card.track(args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with card:
        run(*args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    card = card.result()
    wrapped = {n: fn.launches for n, fn in WRAPPERS.items()}
    t0 = time.perf_counter()
    meta = dryrun.count_step(cfg, shape, tcfg).result()
    meta_s = time.perf_counter() - t0

    what = f"{label} {cfg.name} {shape.kind} B={shape.global_batch} " \
           f"S={shape.seq_len}"
    ops_diff = {k: (card["ops"].get(k, 0), meta["ops"].get(k, 0))
                for k in set(card["ops"]) | set(meta["ops"])
                if card["ops"].get(k, 0) != meta["ops"].get(k, 0)}
    check(not ops_diff, f"{what}: op counts differ (card, meta): {ops_diff}")
    check(card["flops"] == meta["flops"] and card["bytes"] == meta["bytes"],
          f"{what}: card {card['flops']} FLOPs {card['bytes']} B, meta "
          f"{meta['flops']} FLOPs {meta['bytes']} B")
    launches = {n: k["launches"] for n, k in card["kernels"].items()}
    check(launches == {n: k["launches"] for n, k in meta["kernels"].items()}
          and launches == wrapped,
          f"{what}: launches card {launches}, meta {meta['kernels']}, "
          f"wrappers {wrapped}")
    new = card["peak_bytes"] - card["base_bytes"]
    check(abs(new - rise) <= P15_PEAK_TOL * rise,
          f"{what}: census peak {new} B vs max_memory_allocated rise {rise}")
    rf = dryrun.roofline(meta["flops"], meta["bytes"],
                         dryrun.model_flops(cfg, shape)["model_flops_6nd"],
                         tcfg.act_dtype)
    print(f"  {what}: card census == meta dry run ({meta_s:.1f} s): "
          f"{meta['flops']:.6e} FLOPs, {meta['bytes']:.6e} B, "
          f"{meta['n_ops']} ops, launches "
          f"{ {n: c for n, c in launches.items() if c} }; peak beyond "
          f"the step's inputs {new / 1e9:.4f} GB (census, meta "
          f"{(meta['peak_bytes'] - meta['base_bytes']) / 1e9:.4f}) vs "
          f"max_memory_allocated rise {rise / 1e9:.4f} GB "
          f"({new / rise - 1:+.2%}); step {step_s * 1e3:.3f} ms (median "
          f"of {len(times)}) vs bound_s {rf['bound_s'] * 1e3:.4f} ms "
          f"({rf['dominant']}; compute {rf['compute_s'] * 1e3:.4f}, memory "
          f"{rf['memory_s'] * 1e3:.4f}): roofline fraction bound/step "
          f"{rf['bound_s'] / step_s:.4f}, 6ND useful/step "
          f"{rf['useful_s'] / step_s:.4f}")
    return launches


def dry_run_phase_15(label):
    """Phase 15: (a) SmolLM-360M's train step, prefill and decode step,
    (b) Zamba2-1.2B's prefill and decode step, (c) xLSTM-1.3B's prefill,
    each counted on the card and on meta (census_vs_dry_run); (d) the dry
    run's SmolLM sweep and its roofline table."""
    print(f"phase 15 on {label} (times are this card's; bound_s from the "
          f"H100 constants of repro_torch.launch.mesh)")
    total = {n: 0 for n in WRAPPERS}
    dev = "cuda"
    bf16 = TrainConfig()
    rng = np.random.default_rng(0)
    tokens = lambda cfg, B, S: torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S)), dtype=torch.int32, device=dev)

    def full_decode(cfg, params, B=SERVE_KW["n_slots"],
                    S=SERVE_KW["s_max"]):
        batch = {"tokens": tokens(cfg, B, 1),
                 "positions": torch.full((B,), S - 1, dtype=torch.int32,
                                         device=dev)}
        return census_vs_dry_run(cfg, ShapeSpec("decode", S, B, "decode"),
                                 bf16, params, batch, "15a/b")

    def add(launches):
        for n, c in launches.items():
            total[n] += c

    for arch in ("smollm_360m", "zamba2_1_2b", "xlstm_1_3b"):
        cfg = configs.get(arch)
        params = lm.init(cfg, torch.Generator(device=dev).manual_seed(15))
        if arch == "smollm_360m":
            train = ShapeSpec("train", TRAIN_S, TRAIN_B, "train")
            batch = {"tokens": tokens(cfg, TRAIN_B, TRAIN_S),
                     "labels": tokens(cfg, TRAIN_B, TRAIN_S)}
            add(census_vs_dry_run(cfg, train, bf16, params, batch, "15a"))
        S = P15_XLSTM_S if arch == "xlstm_1_3b" else P15_PREFILL_S
        part = {"smollm_360m": "15a", "zamba2_1_2b": "15b"}.get(arch, "15c")
        add(census_vs_dry_run(cfg, ShapeSpec("prefill", S, 1, "prefill"),
                              bf16, params, {"tokens": tokens(cfg, 1, S)},
                              part))
        if arch != "xlstm_1_3b":
            add(full_decode(cfg, params))
        del params
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "dryrun.json")
        t0 = time.perf_counter()
        check(dryrun.main(["--arch", "smollm_360m", "--out", out]) == 0,
              "15d: the dry run's SmolLM sweep failed")
        print(f"  15d: python -m repro_torch.launch.dryrun --arch "
              f"smollm_360m in {time.perf_counter() - t0:.1f} s (meta, on "
              f"the host; computed on H100 constants, not measured):")
        print(roofline_report.table(roofline_report.load(out), md=True))
    return total


def mesh_rank(rank: int, world: int, out: str) -> int:
    """Phase 16, one rank (a process of its own, on ``cuda:rank``): the
    sharded step of full-width SmolLM-360M on make_host_mesh(1) for
    P16_STEPS steps (B2 launches, collective calls, times, the first
    step's peak memory), each step's params kept; then rank 0 runs the
    one-process step on the same batches from the same seed and compares
    after each step. Writes ``out/rank<r>.json``."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, process_group
    from repro_torch.models import parallel
    from repro_torch.models.param import ShardingRules
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("smollm_360m")
    shards = TokenShards(vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B)
    bf16 = TrainConfig(adamw=P16_ADAMW)
    res = {"rank": rank, "world": world, "losses": [], "grad_norms": [],
           "launches": [], "collectives": [], "ms": [], "worst": []}

    with process_group("cuda", f"file://{out}/pg") as dev:
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                    shards.batch_at(0, i).items()} for i in range(P16_STEPS)]
        mesh = make_host_mesh(1, dev)
        res["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        step, _, _, init = make_train_step(cfg, mesh, ShardingRules(), bf16,
                                           device=dev)
        state = init(0)
        torch.cuda.synchronize()
        res["state_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        kept = []
        for batch in batches:
            for fn in WRAPPERS.values():
                fn.launches = 0
            parallel.COLLECTIVES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["launches"].append({n: fn.launches
                                    for n, fn in WRAPPERS.items()})
            res["collectives"].append(dict(parallel.COLLECTIVES))
            if not kept:
                res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            res["losses"].append(loss)
            res["grad_norms"].append(float(m["grad_norm"]))
            kept.append(map_tree(torch.clone, state.params))
        if rank == 0:                   # the one-process step, compared
            step1, _, _, init1 = make_train_step(cfg, tcfg=bf16, device=dev)
            one = init1(0)
            for i, batch in enumerate(batches):
                one, m1 = step1(one, batch)
                got, want = tree_leaves(kept[i]), tree_leaves(one.params)
                if world == 1 and i == P16_STEPS - 1:   # mu and nu (whole
                    # on one rank) after the last step
                    got += tree_leaves((state.opt.mu, state.opt.nu))
                    want += tree_leaves((one.opt.mu, one.opt.nu))
                res["worst"].append({
                    "loss": (res["losses"][i], float(m1["loss"])),
                    "grad_norm": (res["grad_norms"][i],
                                  float(m1["grad_norm"])),
                    "equal": bool(world == 1 and all(
                        torch.equal(a, b) for a, b in zip(got, want))),
                    "param_err": max((a.float() - b.float()).abs().max()
                                     .item() for a, b in zip(got, want))})
            del one
        del state, kept
        if world >= 2:
            f32 = dataclasses.replace(bf16, act_dtype=torch.float32)

            def f32_step(cfg, model, batch):
                """One f32 step on make_host_mesh(model) against one
                process's on rank 0; the B2 launches of the mesh's step."""
                mesh = make_host_mesh(model, dev)
                step, _, _, init = make_train_step(cfg, mesh, ShardingRules(),
                                                   f32, device=dev)
                state = init(0)
                flash_attn.flash_attention_fwd.launches = 0
                state, m = step(state, batch)
                out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                       "b2": flash_attn.flash_attention_fwd.launches}
                place = parallel.placement(lm.abstract_params(cfg),
                                           ShardingRules(), mesh)
                whole = [parallel.gather_full(t, leaf, mesh) for t, leaf in
                         zip(tree_leaves(state.params), tree_leaves(place))]
                del state
                if rank == 0:
                    step1, _, _, init1 = make_train_step(cfg, tcfg=f32,
                                                         device=dev)
                    one = init1(0)
                    before = [t.clone() for t in tree_leaves(one.params)]
                    one, m1 = step1(one, batch)
                    after = tree_leaves(one.params)
                    out["loss"] = (float(m["loss"]), float(m1["loss"]))
                    out["excess_over_rtol"] = max(
                        ((a - b).abs() - P16_F32["rtol"] * b.abs()).max()
                        .item() for a, b in zip(whole, after))
                    sq = lambda pairs: math.sqrt(sum(
                        (a - b).double().square().sum().item()
                        for a, b in pairs))
                    out["update_rel_err"] = (sq(zip(whole, after))
                                             / sq(zip(after, before)))
                    del one, before, after
                del whole
                dist.barrier()
                return out

            # SmolLM with every card on the data axis (ZeRO: gradients
            # reduce-scattered, slices all-gathered), then with a model
            # axis of 2 (its 15 heads replicate), then Llama-3-8B cut in
            # depth with every card on the model axis: its heads, KV
            # heads, MLP and vocab cut, B2 on local heads
            res["f32_data"] = f32_step(cfg, 1, batches[0])
            res["f32"] = f32_step(cfg, 2, batches[0])
            cfg8 = dataclasses.replace(configs.get("llama3_8b"),
                                       n_layers=P16_LLAMA_LAYERS)
            b8 = {k: torch.as_tensor(v, device=dev) for k, v in TokenShards(
                vocab=cfg8.vocab, seq_len=TRAIN_S,
                batch=P16_LLAMA_B).batch_at(0, 0).items()}
            res["llama"] = f32_step(cfg8, world, b8)
    with open(Path(out) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def mesh_train_16(label):
    """Phase 16: spawns min(cards, 4) ranks of :func:`mesh_rank` (this
    script with ``--mesh-rank``), waits for them (a failed or stuck rank
    fails the phase; every rank is stopped), and checks their records.
    Returns rank 0's launches over the sharded steps."""
    world = min(torch.cuda.device_count(), 4)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        logs = [open(Path(out) / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             str(r), str(world), out], stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=P16_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            log = (Path(out) / f"rank{r}.log").read_text()
            check(p.returncode == 0, f"16: rank {r} exited {p.returncode}:\n"
                  f"{log[-4000:]}")
        recs = [json.loads((Path(out) / f"rank{r}.json").read_text())
                for r in range(world)]
    wall = time.perf_counter() - t0
    r0 = recs[0]
    for rec in recs:
        for i, n in enumerate(rec["launches"]):
            check(n["flash_attn_fwd"] == LM_B2_PER_STEP and
                  all(c == 0 for k, c in n.items() if k != "flash_attn_fwd"),
                  f"16: rank {rec['rank']} step {i + 1} launches {n}: want "
                  f"{LM_B2_PER_STEP} B2, no other")
        check(all(sum(c.values()) > 0 for c in rec["collectives"]),
              f"16: rank {rec['rank']} ran no collective")
        check(all(np.isfinite(rec["losses"])), f"16: losses {rec['losses']}")
    for i, w in enumerate(r0["worst"]):
        if world == 1:
            check(w["equal"] and w["loss"][0] == w["loss"][1]
                  and w["grad_norm"][0] == w["grad_norm"][1],
                  f"16: (1, 1) step {i + 1} is not the one-process step bit "
                  f"for bit: {w}")
        else:
            bound = P16_BF16_PARAM_SLACK * sum(
                float(lr_at(P16_ADAMW, t)) for t in range(1, i + 2))
            check(abs(w["loss"][0] - w["loss"][1])
                  <= P16_BF16_LOSS_RTOL * abs(w["loss"][1])
                  and w["param_err"] <= bound,
                  f"16: ({world}, 1) step {i + 1}: {w}, params within "
                  f"{bound:.3e}?")
    if world >= 2:
        for key, b2 in (("f32_data", LM_B2_PER_STEP),
                        ("f32", LM_B2_PER_STEP),
                        ("llama", 2 * P16_LLAMA_LAYERS)):
            f = r0[key]
            check(abs(f["loss"][0] - f["loss"][1])
                  <= P16_F32["loss_rtol"] * abs(f["loss"][1])
                  and f["excess_over_rtol"] <= P16_F32["atol"]
                  and f["update_rel_err"] <= P16_F32["update_rel"]
                  and all(rec[key]["b2"] == b2 for rec in recs),
                  f"16: f32 {key} step on {f['mesh']}: {f}, B2 "
                  f"{[rec[key]['b2'] for rec in recs]} (want {b2} a rank)")
    calls = r0["collectives"][-1]
    print(f"phase 16 on {label}: world {world}, mesh {r0['mesh']} "
          f"(make_host_mesh(1)), full-width SmolLM-360M batch {TRAIN_B} seq "
          f"{TRAIN_S} bf16 remat full AdamW, {P16_STEPS} steps, {wall:.1f} s "
          f"with the ranks' start")
    print(f"  losses {r0['losses']}; grad norms {r0['grad_norms']}; B2 "
          f"{LM_B2_PER_STEP} a step on each rank, no other kernel")
    print(f"  collective calls a step {sum(calls.values())} {calls}; ms a "
          f"step (host clock, ends in a sync) "
          f"{[round(t, 3) for t in r0['ms']]} (the first holds the first "
          f"call's costs); peak memory a rank in step 1 "
          f"{[round(rec['peak_gb'], 4) for rec in recs]} GB (its state "
          f"before it {[round(rec['state_gb'], 4) for rec in recs]} GB)")
    if world == 1:
        print(f"  (1, 1) mesh == the one-process step bit for bit in loss, "
              f"grad norm and params after each of {P16_STEPS} steps, and "
              f"in mu and nu after the last")
    else:
        print(f"  ({world}, 1) vs one process: "
              f"{[(w['loss'], w['param_err']) for w in r0['worst']]}; one "
              f"f32 SmolLM step: {r0['f32_data']} and {r0['f32']}; one f32 "
              f"step of Llama-3-8B "
              f"at published widths, reduced: n_layers 32 -> "
              f"{P16_LLAMA_LAYERS}, batch {P16_LLAMA_B} x {TRAIN_S}: "
              f"{r0['llama']}")
    total = {n: sum(step[n] for step in r0["launches"]) for n in WRAPPERS}
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_run = time.perf_counter()

    def phase_done(what):
        print(f"[{time.perf_counter() - t_run:.1f} s] {what} done")

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(secs)} "
          f"(nvcc sm_90a, in parallel)")
    for name in secs:                      # the compiler's -Xptxas=-v report
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {"flash_attn_fwd": [], "decode_attn": [], "split_quant": [],
            "mamba_scan": [], "mlstm_scan": []}
    for dtype in (torch.bfloat16, torch.float32):
        for S in PREFILL_S:
            rows["flash_attn_fwd"].append(check_prefill(dtype, S, gen, flush))
        rows["decode_attn"].append(check_decode(dtype, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):     # Zamba2's MHA heads
        rows["flash_attn_fwd"].append(check_prefill(
            dtype, 512, gen, flush, H=MHA_H, KV=MHA_H))
        rows["decode_attn"].append(check_decode(dtype, gen, flush, H=MHA_H,
                                                KV=MHA_H))
    for dtype in (torch.bfloat16, torch.float32):     # Granite's GQA heads
        for S in GRANITE_PREFILL_S:
            rows["flash_attn_fwd"].append(check_prefill(
                dtype, S, gen, flush, H=GRANITE_H, KV=GRANITE_KV))
        rows["decode_attn"].append(check_decode(
            dtype, gen, flush, H=GRANITE_H, KV=GRANITE_KV))
    for dtype in (torch.bfloat16, torch.float32):     # head dim 16 (smoke)
        rows["flash_attn_fwd"].append(check_prefill(
            dtype, 512, gen, flush, H=SMOKE_H, KV=SMOKE_H, D=SMOKE_D))
        rows["decode_attn"].append(check_decode(
            dtype, gen, flush, H=SMOKE_H, KV=SMOKE_H, D=SMOKE_D))
    for dtype in (torch.bfloat16, torch.float32):     # head dim 128
        for h, kv in D128_HEADS:
            rows["flash_attn_fwd"].append(check_prefill(
                dtype, D128_S, gen, flush, H=h, KV=kv, D=D128))
            rows["decode_attn"].append(check_decode(
                dtype, gen, flush, H=h, KV=kv, D=D128))
    rows["flash_attn_fwd"].append(check_prefill(     # Mixtral's window
        torch.bfloat16, MIXTRAL_WINDOW_S, gen, flush, H=32, KV=8, D=D128,
        window=MIXTRAL_WINDOW))
    torch.cuda.empty_cache()
    for label, x in quant_cases(gen):
        for fused in (False, True):
            rows["split_quant"].append(check_quant(label, x, fused, flush))
    empty_ms = time_ms(lambda: None, flush=flush)
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in MAMBA_SHAPES:
            rows["mamba_scan"].append(check_mamba(dtype, B, S, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in MLSTM_SHAPES:
            rows["mlstm_scan"].append(check_mlstm(dtype, B, S, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):     # SmolLM's training
        rows["flash_attn_fwd"].append(check_flash_train(dtype, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):     # lse at head dim 128
        rows["flash_attn_fwd"].append(check_flash_train(
            dtype, gen, flush, B=1, S=D128_S, H=32, KV=8, D=D128))
    for dtype in (torch.bfloat16, torch.float32):     # Whisper-small
        # the encoder (non-causal over its 1,500 frames, with and without
        # lse, and the Function's gradients), cross-attention at prefill
        # (64 prompt rows against the frames) and at decode (the fixed
        # memory, every row at full length)
        rows["flash_attn_fwd"].append(check_flash_train(
            dtype, gen, flush, B=1, S=WHISPER_FRAMES, H=WHISPER_H,
            KV=WHISPER_H, causal=False))
        rows["flash_attn_fwd"].append(check_prefill(
            dtype, WHISPER_PROMPT, gen, flush, H=WHISPER_H, KV=WHISPER_H,
            B=WHISPER_B, Skv=WHISPER_FRAMES, causal=False))
        rows["decode_attn"].append(check_decode(
            dtype, gen, flush, H=WHISPER_H, KV=WHISPER_H, S=WHISPER_FRAMES,
            lens=[WHISPER_FRAMES] * DECODE_B))
    grad_rows = [check_scan_grads(kind, dtype, gen)
                 for kind in ("mamba_scan", "mlstm_scan")
                 for dtype in (torch.bfloat16, torch.float32)]
    print(f"kernels vs plain on {smi} (ms, median of 20, L2 flushed; an "
          f"empty event pair {empty_ms:.4f}):")
    for name, rs in rows.items():
        for r in rs:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            ratios = ""
            if name != "split_quant":
                vs_lib = ("n/a" if r["library_ms"] is None
                          else f"{r['ms'] / r['library_ms']:.2f}x")
                ratios = (f" kernel/library {vs_lib} kernel/bound "
                          f"{r['ms'] / r['bound_ms']:.1f}x")
            if name == "decode_attn":
                ratios += (f" splits {r['splits']} of {r['split_rows']} rows "
                           f"per (KV head, batch row)")
            if "lse_err" in r:
                ratios += (
                    f"\n    without lse {r['ms_no_lse']:.4f} ms (lse "
                    f"{r['ms'] / r['ms_no_lse'] - 1:+.1%}); lse max_abs_err "
                    f"{r['lse_err']:.3e}; the Function's gradients vs the "
                    f"plain path's {r['grad_err']:.3e}; plain backward "
                    f"{r['bwd_ms']:.4f} ms (bound {r['bwd_bound_ms']:.4f}, "
                    f"{r['bwd_bound_by']}), SDPA forward + backward "
                    f"{r['sdpa_fwd_bwd_ms']:.4f} ms")
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} plain "
                  f"{r['plain_ms']:.4f} library {lib} bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err "
                  f"{r['max_abs_err']:.3e}{ratios}")
            if name == "split_quant":
                dev = sum(ms for *_, ms in r["device"])
                print(f"    device time (torch.profiler, 20 calls) {dev:.4f} "
                      f"ms = {dev / r['bound_ms']:.1f}x bound ("
                      + "; ".join(f"{k[:48]} {c:g}x {ms:.4f}"
                                  for k, c, ms in r["device"])
                      + f"); copy_ of x into x's layout {r['copy_ms']:.4f} ms")
            if name == "mamba_scan" and r["stages"]:
                print("    device time by kernel (torch.profiler, 20 calls): "
                      + "; ".join(f"{k[:40]} {c:g}x {ms:.4f} ms"
                                  for k, c, ms in r["stages"]))
            if name == "mlstm_scan":
                stages = "; ".join(f"{k[:40]} {c:g}x {ms:.4f} ms"
                                   for k, c, ms in r["stages"] or [])
                print(f"    h of the plain version at chunk 256 vs at the "
                      f"kernel's chunk: {r['spread']:.3e}"
                      + (f"; device time by kernel (torch.profiler, 20 "
                         f"calls): {stages}" if stages else ""))
    for r in grad_rows:
        print(f"  {r['kind']} autograd Function {r['shape']}: {r['grads']} "
              f"gradients bit for bit the plain path's (all nonzero: "
              f"{r['nonzero']}), forward at phase 3's tolerance; backward "
              f"(the plain scan's, recomputed) {r['bwd_ms']:.4f} ms")
    scan = rows["mamba_scan"][2]                      # S=512 bf16
    print(f"  mamba_scan bound at S=512 bf16: {scan['bytes'] / 1e6:.2f} MB "
          f"-> {scan['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s; "
          f"{scan['ops'] / 1e9:.3f} GFLOP -> "
          f"{scan['ops'] / PEAK_OPS[torch.bfloat16] * 1e3:.4f} ms at the "
          f"bf16 tensor peak, {scan['ops'] / PEAK_OPS[torch.float32] * 1e3:.4f}"
          f" ms at the f32 peak; the script uses the inputs' type (bf16): "
          f"bound {scan['bound_ms']:.4f} ms by {scan['bound_by']}")
    mscan = rows["mlstm_scan"][2]                     # S=512 bf16
    print(f"  mlstm_scan bound at S=512 bf16: {mscan['bytes'] / 1e6:.2f} MB "
          f"-> {mscan['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"{mscan['ops'] / 1e9:.3f} GFLOP -> "
          f"{mscan['ops'] / PEAK_OPS[torch.bfloat16] * 1e3:.4f} ms at the "
          f"bf16 tensor peak, "
          f"{mscan['ops'] / PEAK_OPS[torch.float32] * 1e3:.4f} ms at the "
          f"f32 peak; bound {mscan['bound_ms']:.4f} ms by "
          f"{mscan['bound_by']}")
    del flush
    phase_done("phases 2-3 (build, kernels vs plain)")

    paths = {"smollm_360m": serve_full_width("smollm_360m", smi)[0]}
    torch.cuda.empty_cache()
    phase_done("phase 4 (SmolLM-360M)")
    ring_launches, numpy_gen_ms = train_full_width(smi)
    paths["resnet18_ring"] = {"split_quant": ring_launches}
    autoencoder_pass_224(smi)
    torch.cuda.empty_cache()
    phase_done("phase 5 (training ring)")
    paths["zamba2_1_2b"] = serve_full_width("zamba2_1_2b", smi)[0]
    torch.cuda.empty_cache()
    phase_done("phase 6 (Zamba2-1.2B)")
    paths["xlstm_1_3b"] = serve_full_width("xlstm_1_3b", smi)[0]
    torch.cuda.empty_cache()
    phase_done("phase 7 (xLSTM-1.3B)")
    paths["device_loop_resnet18"] = {
        "split_quant": device_loop_full_width(smi, numpy_gen_ms)}
    torch.cuda.empty_cache()
    phase_done("phase 8a")
    paths["device_loop_1000"] = {"split_quant": device_loop_1000(smi)}
    phase_done("phase 8b")
    torch.cuda.empty_cache()
    paths["fleet_resnet18"] = {"split_quant": fleet_full_width(smi)}
    torch.cuda.empty_cache()
    phase_done("phase 9a")
    fleet_smoke_9b(smi)
    phase_done("phase 9b")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    p10_launches = degraded_fleet_full_width(smi, flush)
    del flush
    paths["fleet_degraded_resnet18"] = {"split_quant": p10_launches}
    torch.cuda.empty_cache()
    phase_done("phase 10a")
    isl_smokes_10b(smi)
    phase_done("phase 10b")
    paths["granite_3_2b"] = granite_serving_fleet_11a(smi)
    torch.cuda.empty_cache()
    phase_done("phase 11a (Granite-3.0-2B, the serving fleet)")
    serving_clis_11b(smi)
    phase_done("phase 11b")
    paths["smollm_360m_train"] = lm_train_12a(smi)
    torch.cuda.empty_cache()
    phase_done("phase 12a (launch.train, SmolLM-360M)")
    paths["smollm_360m_split_ring"] = lm_split_ring_12b(smi)
    torch.cuda.empty_cache()
    phase_done("phase 12b (the split ring, SmolLM-360M)")
    paths["smoke_lm_train"] = smoke_train_12c(smi)
    phase_done("phase 12c (Zamba2, xLSTM, Mixtral and Phi-3.5-MoE smoke "
               "steps)")
    t13 = time.perf_counter()
    paths["mixtral_8x7b"] = mixtral_13a(smi)
    phase_done("phase 13a (Mixtral-8x7B, 16 of 32 layers)")
    paths["two_unit_d128"] = {n: 0 for n in WRAPPERS}
    for arch in TWO_UNIT:
        for n, c in two_unit_13b(arch, smi).items():
            paths["two_unit_d128"][n] += c
    phase_done(f"phase 13b (Llama-3-8B, InternLM2-20B, Qwen2-VL-7B, "
               f"Phi-3.5-MoE at 2 units); phase 13 took "
               f"{time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    paths["whisper_small_serve"] = whisper_serve_14a(smi)
    phase_done("phase 14a (Whisper-small, prefill + decode)")
    paths["whisper_small_train"] = whisper_train_14b(smi)
    torch.cuda.empty_cache()
    phase_done("phase 14b (launch.train, Whisper-small)")
    paths["examples"] = examples_14c(smi)
    torch.cuda.empty_cache()
    phase_done(f"phase 14c (the four examples); phase 14 took "
               f"{time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    paths["dry_run_vs_card"] = dry_run_phase_15(smi)
    torch.cuda.empty_cache()
    phase_done(f"phase 15 (the dry run against the card) took "
               f"{time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    paths["smollm_360m_mesh"] = mesh_train_16(smi)
    phase_done(f"phase 16 (the train step on a mesh) took "
               f"{time.perf_counter() - t16:.1f} s")
    print(f"launches on the main paths (B1: counted by its wrapper at each "
          f"launch; the device loop is eager, no graph): {paths}")
    launches = {n: sum(p.get(n, 0) for p in paths.values()) for n in WRAPPERS}

    # the kernels at the main paths' largest shapes (attention in bf16 at
    # SmolLM's heads, the quantizer's fused entry at ResNet-18's f32 l2
    # boundary as the ring hands it over, channel-major; the scans in
    # bf16 at S=512)
    pick = {"flash_attn_fwd": rows["flash_attn_fwd"][PREFILL_S.index(512)],
            "decode_attn": rows["decode_attn"][0],
            "split_quant": next(r for r in rows["split_quant"] if r["shape"]
                                == "quantize_dequantize (8, 28, 28, 128) "
                                   "float32 channel-major"),
            "mamba_scan": scan, "mlstm_scan": mscan}
    meta = {"flash_attn_fwd": ("src/repro_torch/csrc/flash_attn_fwd.cu",
                               "src/repro/kernels/flash_attn.py:126"),
            "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                            "src/repro/kernels/decode_attn.py:88"),
            "split_quant": ("src/repro_torch/csrc/split_quant.cu",
                            "src/repro/kernels/split_quant.py:35"),
            "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                           "src/repro/kernels/mamba_scan.py:101"),
            "mlstm_scan": ("src/repro_torch/csrc/mlstm_scan.cu",
                           "src/repro/kernels/mlstm_scan.py:129")}
    kernels = [dict(name=n, route="cuda", source=meta[n][0],
                    replaces=meta[n][1], launches=launches[n],
                    max_abs_err=max(r["max_abs_err"] for r in rows[n]
                                    if n == "split_quant"
                                    or "bfloat16" in r["shape"]),
                    ms=pick[n]["ms"], plain_ms=pick[n]["plain_ms"],
                    bound_ms=pick[n]["bound_ms"], bound_by=pick[n]["bound_by"],
                    library_ms=pick[n]["library_ms"])
               for n in ("flash_attn_fwd", "decode_attn", "split_quant",
                         "mamba_scan", "mlstm_scan")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        if not torch.cuda.is_available():
            sys.exit(1)
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
