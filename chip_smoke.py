"""Smoke run of the PyTorch/CUDA port (nbasr_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. card: its name and power limit, as nvidia-smi reports them;
2. build: nvcc compiles the four kernel libraries of nbasr_torch/csrc
   into build/;
3. kernels: the fused cell forward kernel against its plain PyTorch version
   on the card, at the four flagship widths (block 0-3 of a serving
   window), on every node kind, in f32 and bf16, two calls bit-equal; NaN,
   +inf and -inf in x on three specs, where the output must be NaN and
   +-inf exactly where the plain version's (on the CPU) is; then its time
   per cell on CUDA events and as device time, beside its bound;
4. serving: the flagship model (26,339,349 parameters, random weights from a
   seed) streams four 8 s streams of seeded audio, one ending 2 s early,
   through StreamingASR at chunk_frames=240 and StreamingGreedyDecoder;
   every SearchCell must go through the kernel (18 launches per device
   step, no call of the plain version);
5. check: the card's f32 logits against the same port run on the CPU, and
   the same stream in bf16 against f32;
6. train kernels: the training forward (dropout 0 and 0.2, same seed) and
   the backward kernel against their plain versions at the four widths of
   the train-step batch (B=4), on every node kind and on a cell without
   LayerNorm, in f32 and bf16: output, saved node outputs, saved
   multipliers (the dropout masks must agree exactly), dx, every dW
   and db, dscale and dbias, and two backward calls bit-equal; three specs
   with 50 groups of 24 channels at C=1200; the same for the flagship
   cell at the train step's own shapes (B=32, dropout 0.2); NaN, +inf and
   -inf in dy, where the backward's outputs must be NaN and +-inf exactly
   where the plain version's (on the CPU) are, and in x, where the
   training forward's output, node outputs and multipliers must be; the
   training forward bit-equal across two calls; the kept share of one large
   dropout draw; the forward and backward times per flagship cell at the
   train step's shapes beside their bounds, on CUDA events and as device
   time, and the forward's kernel launches per cell from a profiler trace;
7. train step: the flagship at full width in bf16, B=32, dropout 0.2, on
   synthetic ≤3 s utterances: 2 warm-up and 5 timed Trainer steps (ms per
   step, audio-s/s), 18 forward and 18 backward kernel launches per step
   and no plain call, finite loss, and a torch.profiler split of one step;
8. train check: one f32 step's gradients before clipping (full width, B=2,
   cell dropout 0.2 with the same masks on both sides) on the card against
   the same port on the CPU, beside witnesses that split the difference:
   the card's kernels against the plain cells run on the card, each tensor
   held to a bound read from the card's own 1-ulp audio nudge of it, a
   planted fault in one cell's backward that bound must reject, and each
   side against itself with the input audio nudged by one ulp;
9. grouped conv kernels (``grouped_impl`` 'pallas' and 'pallas_split'):
   the forward (with and without its bias + clip-ReLU epilogue), dx and dW
   kernels against their plain versions at the four train-step widths
   (B=4), K/d 5/1, 5/2, 7/1, 7/2, on a dense tensor seen as a strided split
   view and on a contiguous split tensor, f32 and bf16, two calls
   bit-equal; all three also at edge shapes (groups of 24 and of 1, T
   below the halo, B=1, K=9, one group of 800, ci != co) on a third,
   g-strided view, dx also on a dz expanded along T; NaN and inf inputs
   through the forward (in x) and dx (in dz); then at B=32 with conv5,
   checked and timed
   beside their bounds, plain versions and the cuDNN call that computes
   the same function, on CUDA events and as device time;
10. grouped forward: the flagship's f32 logits with 'pallas' and
   'pallas_split' against 'fused' on the card, same weights, one B=4
   batch; 54 forward kernel launches per model forward, no plain call;
   the same for the JAX package's XLA lowerings 'chunked', 'masked_dense'
   and 'native' (stock PyTorch, no kernel of ours) and for the tap-matmul
   block convs (18 fused cell launches);
11. grouped train steps: phase 7 for 'pallas' and 'pallas_split' (54
   forward, 54 dx and 54 dW launches per step, no plain call, no fused
   cell launch), beside the fused step of phase 7 in the same call; and one
   f32 step's gradients (B=2, cell dropout 0.2) on the card against the
   same configuration with the plain versions on the card, and, as a
   witness, 'pallas' against 'fused' (the same gate rule and masks);
   phases 7 and 11 also count one CTC alpha and one beta launch per step;
12. CTC kernels: the alpha and beta recursions against their plain
   versions on the card, in f32, two calls bit-equal, at the train step's
   shapes (the loader's batch, T=75, B=32, S=65), an eval batch's (T=200,
   B=16, S=161), one frame (T=1), and on the block path S=257 (the first
   row too long for a warp), S=513 and S=8193 (the state in shared memory
   beside a cp.async ring) and S=24577 (the state in global memory), each
   with a row without labels, repeated labels, padded frames and an
   impossible alignment; the path each case took and its time on CUDA
   events and as device time; the loss and its logits gradient with the
   kernels against the plain versions, and F.ctc_loss as a witness;
   plain, bound and F.ctc_loss times;
13. eval: Trainer.evaluate with the default beam search (W=12) over the
   synthetic val split with the flagship on the card (one alpha launch per
   batch, no beta, no plain call), and beam_search_decode on the card
   against the CPU on the same logits;
14. NAS path: the committed db/ folders queried without JAX (the flagship's
   golden hash, finite PERs); grad_norm, snip and synflow at full width,
   f32, on the CLI's B=1, T=128 batch, over four architectures that hold
   all six ops (the all-zero one among them), each through compute_proxy
   (18 forward and 18 backward fused cell launches a call, one alpha and
   one beta for the loss proxies, no plain call); then the same model's
   pass with every cell call's forward and backward kernel held against
   its plain version on the same inputs, and its score, output and every
   gradient tensor against the plain versions' pass on the card (the
   score within a bound read from a witness: each cell's parameters,
   output and incoming gradient nudged by one ulp); synflow exactly 0;
   two faults planted in the backward kernel that both checks reject; ms
   a call, first-call planning and model build apart; then proxy_search
   (synflow and grad_norm, 8 candidates, the top 5 in the plain versions'
   order) and the CLI's proxy command on the card;
15. checkpoints, int8 serving, remat: the full-width flagship takes 2 bf16
   steps (B=32) and nbasr_torch.checkpoint.save_flax writes the JAX
   trainer's latest.ckpt; a fresh Trainer loads it through Trainer.load
   (parameters, Adam's step and moments, step count bit-equal), and its
   next step, on the writer's generator state, is bit-equal to the
   writer's (18 + 18 fused and 1 + 1 CTC launches, no plain call; cuDNN
   deterministic for both); write and read MB/s; `python -m
   nbasr_torch.cli quantize` on the file (its ratio, every q and s equal
   to quant.quantize_tree here); StreamingASR(quantize=True) streams
   phase 4's audio in f32 and bf16 (18 fused launches per device step, no
   plain call), the card's int8 logits against the same int8 port on the
   CPU within phase 5's 1e-3 and against the f32 stream within a bound
   read from the CPU; the int8 streamer's resident bytes once its caller
   drops the model, and the dequantization's share of a device step
   beside its bound; one bf16 step with remat_cells against one without
   (gradients bit-equal, 36 forward and 18 backward launches, peak memory
   of each);
16. the sweep, data parallelism and the native runtime: the native host
   runtime (built with g++) parses seeded RIFF and SPHERE bytes as the
   Python parser does, its Levenshtein equals edit_distance on the card on
   phase 13's beam hypotheses, its beam search the card's where the top-2
   margin is clear; run_sweep of the flagship and [[0,1],[2,1,0],[4,0,1,1]]
   x seed 1234 x 1 epoch (B=32, beam eval, f32): 18 + 18 fused and 1 + 1
   CTC launches a train step, 18 + 1 an eval batch, no plain call, the
   file read back, the resume replay launching nothing and writing the
   same bytes, the same rows on two worker threads sharing the card;
   static_info_pass (the flagship's 26,339,349 parameters) and
   benchmark_pass (median ms of 20 B=1, T=500 f32 forwards an arch, read
   back by from_folder); the train twin under torchrun at --dp 1;
   ParallelTrainer over NCCL at world size 1, its bf16 step bit-equal to
   the plain Trainer's; two gloo ranks on the one card (f32, dropout 0,
   B=16 each), their gradients before clipping within phase 8's bound of
   one rank's on B=32, a planted world-size factor rejected; the CLI's
   sweep, info and benchpass in subprocesses; entry()'s forward;
17. tensor parallelism and seq_parallel_apply: (a) the fused forward and
   backward kernels at the tp=2 shard shapes (C/2 = 300-600 channels in 50
   groups, no LayerNorm, dropout 0.2 at channel offset c0 = C/2), f32 and
   bf16, against their plain versions (masks exact, two calls bit-equal);
   (b) the full-width flagship at tp=2 on two gloo ranks of the one card
   (f32, B=16, cell dropout 0.2, 'auto'): the gathered gradients before
   clipping against one process's on the same masks, each tensor within
   min(0.1, max(1e-3, 4 x the largest move of four witnesses: three 1e-7
   audio nudges and the other cell kernels)), a planted sliced-gradient
   fault rejected, 18 + 18 fused launches at shard
   shapes and 1 + 1 CTC a rank, no plain call, every local shape as
   param_spec says; (c) the same at dp=2 x tp=2 on four gloo ranks
   (global B=32, dropout 0), and one 'pallas' tp=2 step at B=8 (54 + 54 +
   54 grouped launches a rank) against one process's 'pallas' step; (d)
   five bf16 tp=2 steps at B=32 timed, with the tensor-parallel
   collectives' share of the wall; (e) seq_parallel_apply on four gloo
   ranks (f32, B=2, T=2176), 'chain' and 'gather', against the unsharded
   forward, 18 launches of #1 a rank, and the wall of a call against it;
   (b') one f32 'pallas_split' tp=2 step at B=8 (dropout 0.2, every cell
   channel-parallel on its rank's 50 groups in the split layout: 54 + 54 +
   54 launches of #8-#10 a rank, 1 + 1 CTC) against one process's, within
   the rule of (b) on three audio nudges, a planted sliced-gradient fault
   rejected; (e') the gradients of sum(w * logits) through
   seq_parallel_apply in both modes (the parameters' summed over the four
   ranks, the features' shards joined) against the unsharded model's,
   within the rule of (b) on three 1e-7 nudges of the features, 18 + 18
   launches a rank, and a planted fault in each mode's backward rejected;
18. the learning proof on the tone-coded corpus (four pure tones, 0.2 s
   segments; nbasr_torch.tools.per_run, quant_per_check, recipe_seeds;
   cuDNN deterministic): (a) one step of the JAX test's recipe (the
   flagship arch at 32/32/48/48, 4 groups, one cell a block, no LSTM, f32)
   on its first batch: #1 and #2 on each cell's own input and output
   gradient against their plain versions (phase 6's check), the step's
   gradients, kernels against plain versions, within phase 8's rule on
   three 1e-7 audio nudges, a planted fault rejected; then the recipe
   (40 epochs at lr 1e-3, B=8, beam W=12) through #1-#4 from init seeds
   0-8, every step's and eval batch's launches counted, none plain; each
   run judged by the JAX test's asserts (best < 0.5, the test eval on
   the best weights < 0.6, epoch 1 > 0.6), a majority of the runs
   passing all three; (b) int8 PTQ of
   each run's best weights: CTC loss within 5% of f32's on every run, val
   PER within 0.02 on a majority, and the relative L2 of int8 logits
   against f32's; (c) the
   full-width flagship on per_run's recipe (bf16, LSTM, dropout 0.2, B=16,
   256 utterances) for 3 epochs: finite losses, the epoch-3 train loss
   below epoch 1's, seconds an epoch and each epoch's val LER printed;
19. the port's speed record: ``python -m nbasr_torch.bench`` (bench.py's
   two measurements of the flagship: the f32 B=1, T=500 forward, 100
   blocking and 50 pipelined calls; the bf16 B=32 'auto' train step in
   blocks of 10, its FLOPs, MFU, peak memory and a profiled window) in its
   own process, exit 0; its last line holds every key of BENCH_r05.json's
   result and the twin's own, every time, rate, share and memory figure
   finite and positive, 18 fused forward launches per forward and 18 + 18
   + 1 + 1 per train step with none plain, and algorithmic_tflops equal to
   algorithmic_flops at the batch's rows and longest utterance; its median
   forward printed beside phase 16's benchmark_pass median.
20. the LSTM recurrence kernels (``csrc/lstm.cu``): FastLSTM(1200, 500) at
   the recipe's bf16 train shapes (B=64, T=75; B=48, T=196; with and
   without a carry; forward and backward), f32 serving (B=64, T=60, the
   carry in and out) and the proxies' B=1 with a backward, one launch each
   way, two calls bit-equal; every output and gradient against a float64
   copy within twice the plain versions' own gap (or 1e-5 of the tensor's
   largest value); events and device time beside the plain loop's; the
   flagship's train step and serving head through the kernels.
21. the Conformer's kernels: the hash dropout (Triton) bit-equal to its
   plain version on the card, forward and backward; the relative-position
   attention (``csrc/relpos_attention.cu``) forward and backward against
   its plain version on the card in f32 and bf16 at small shapes with
   padded rows and odd T, and in bf16 at the conformer-l.train cell's two
   bucket shapes (B=64, T'=399; B=32, T'=875; H=8, d=64): every output
   and gradient within its limit, the memory a call adds within its
   outputs and log-sum-exp (so no T x T buffer exists), events and device
   time beside the bound and the plain version's; then one bf16 Conformer
   (L) ``Trainer.step`` at B=32 x 3,504 frames with 17 + 17 attention
   kernel calls and 206 dropout calls, none plain.
22. the linear node's tensor-core GEMMs (``csrc/linear_mma.cuh``) at
   timit-recipe's buckets (B=64 x 300, B=48 x 784 frames) and the
   proxies' B=1 x 128, at each block's width with T halved by the stride-2
   blocks: the forward's output and multipliers and the backward's dx, dW
   and db against the plain versions on the card, the backward bit-equal
   across two calls, the ``cell.linear_mma`` counter; each product's device
   time, TFLOP/s and share of the bf16 peak beside ``torch.matmul``'s time
   (a yardstick only); an f32 cell on the SIMT kernels
   (``cell.linear_fma``).

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import functools
import gc
import io
import json
import math
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import nbasr_torch
from nbasr_torch import checkpoint, cli, entry, native, quant, search, \
    search_space
from nbasr_torch.bench import DEVICE_METRICS, card_line, device_kernels, \
    device_seconds, launch_counts, power_limit_w, reset_launches
from nbasr_torch.convert import from_flax
from nbasr_torch.data.pipeline import Loader, get_dataloaders, \
    make_synthetic_split
from nbasr_torch.models.asr import algorithmic_flops, count_params, \
    get_model, logits_length
from nbasr_torch.models.cell import SearchCell
from nbasr_torch.models import proxies
from nbasr_torch.models.layers import conv_padding
from nbasr_torch.models.lstm import FastLSTM
from nbasr_torch.ops import _build, ctc, ctc_pallas, decode, fused_cell, \
    grouped_conv
from nbasr_torch.ops.fused_cell import FusedCellSpec
from nbasr_torch.ops.grouped_conv import to_split
from nbasr_torch.ops.plain import plain_cells, plain_convs, plain_ctc
from nbasr_torch.parallel import ParallelTrainer, benchmark_pass, run_sweep, \
    static_info_pass, unique_architectures
from nbasr_torch.search_space import arch_vec_to_names
from nbasr_torch.serving import StreamingASR, StreamingGreedyDecoder
from nbasr_torch.training import Trainer, ratios
from nbasr_torch.tools import recipe_seeds
from nbasr_torch.utils import flatten

SEED = 0
FLAGSHIP = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
B = 4
# (C, T) of each block's cells in one serving window: 24 + 240 + 508 = 772
# frames at chunk_frames=240, halved by the stride-2 blocks 2 and 3
WIDTHS = ((600, 772), (800, 772), (1000, 386), (1200, 193))
CELLS_PER_BLOCK = (3, 4, 5, 6)
# cell specs that cover every node kind: conv5/conv5d2/conv7/conv7d2,
# linear, zero (with and without branches), skips, and the TF quirks
SPECS = {
    'flagship': dict(arch=FLAGSHIP),
    'linear+dilated': dict(arch=[[0, 1], [2, 1, 0], [4, 0, 1, 1]]),
    'conv7+zero+linear': dict(arch=[[3, 0], [5, 1, 1], [0, 1, 0, 1]]),
    'tf_quirks': dict(arch=[[2, 1], [3, 1, 0], [5, 0, 0, 1]],
                      branch_semantics='tf_inverted', apply_dilation=False,
                      pad_math='tf'),
    # no LayerNorm: the last node writes y, and a training forward must
    # still hand back its output among the saved node outputs
    'flagship no-norm': dict(arch=FLAGSHIP, use_norm=False),
}
# Kernel against plain version, as a share of max|plain|.  f32: both sum
# in f32, in other orders, over <= 84 (conv) or <= 1200 (linear) terms, so
# they differ by a few ulps (~1e-6) before the LayerNorm divides by the
# row's spread; 1e-4 leaves two decades of margin.  bf16: where the two
# f32 sums straddle a rounding boundary a node output rounds to the
# neighbouring bf16 value (2^-8 relative), and later nodes and the
# LayerNorm carry such flips; 2e-2 is about five bf16 ulps of the scale.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Card against CPU, f32 logits of the whole stream, as a share of max|cpu|:
# cuDNN, oneDNN and the two cell versions sum in other orders in each of
# 22 conv layers and the 60-step LSTM recurrence; 1e-3 bounds that.
SERVE_TOL = 1e-3
# bf16 stream against the f32 stream, as relative L2 error of the logits.
# The random-weight flagship amplifies a perturbation about 1.2x per cell:
# on the CPU the bf16 encoder drifts from f32 by 0.5% (L2) after the first
# block conv and 27% after the last cell, and the logits by ~18%.  0.4
# catches a broken bf16 path (which lands at 100% and more), not that drift.
BF16_SERVE_TOL = 0.4
# H100 SXM peaks (NVIDIA data sheet): HBM3, f32 outside the tensor cores,
# dense bf16 on the tensor cores
MEM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
AUDIO_SECONDS = 8.0
SHORT_BY_SECONDS = 2.0
SAMPLE_RATE = 16000
# The train step: synthetic:64 utterances of 0.25-3 s, all in the first
# bucket, padded to 300 frames, so the cells see T = 300/300/150/75
# (strides 1, 1, 2, 2) at B=32; the kernel checks run B=4 at those T.
TRAIN_B = 32
CHECK_B = 4
TRAIN_WIDTHS = ((600, 300), (800, 300), (1000, 150), (1200, 75))
TRAIN_DATA = 'synthetic:64'
DROPOUT = 0.2
TRAIN_SEED = (1234567, 7654321)
WIDE_GROUPS = 50          # ci = 24 at C=1200: groups wider than 16 channels
TRAIN_CHECKED_AT = ('B=4 at T=300/300/150/75 on the five SPECS (one without '
                    'LayerNorm), dropout 0 and 0.2, output, saved node '
                    'outputs and multipliers; three SPECS with 50 groups of 24 channels at '
                    'C=1200, T=75; the flagship cell at B=32, dropout 0.2 '
                    '(the train step\'s shapes); f32 and bf16; the backward '
                    'bit-equal across two calls at each, and with NaN, +inf '
                    'and -inf in dy (BWD_NONFINITE_AT)')
# The backward with non-finite dy: three SPECS (their conv dx stored into
# a gradient buffer, added after branch adds, rounded into dx) at B=4,
# C=600, T=300, dropout 0.2, f32 and bf16, NONFINITE's values planted in
# dy; the plain version runs on the CPU, as phase 9's non-finite check.
BWD_NONFINITE_SPECS = ('flagship', 'linear+dilated', 'conv7+zero+linear')
BWD_NONFINITE_AT = ('dy with NaN, +inf and -inf at B=4, C=600, T=300 on the '
                    'flagship, linear+dilated and conv7+zero+linear specs, '
                    'dropout 0.2, f32 and bf16')
# Backward kernel against its plain version on the same saved inputs, as a
# share of each gradient's max|plain|.  f32: both sum in f32 in other
# orders, dW and db over B*T = 300-1200 rows, so they differ by ~1e-6 of
# the scale; 1e-4 leaves two decades.  bf16: dz is rounded to bf16 before
# the dW and dx products and dW, dx are rounded at the end; where the two
# f32 sums straddle a rounding boundary a value moves by one bf16 ulp
# (2^-8 of itself) and carries into the nodes before it; 2e-2 is about
# five ulps of the scale.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Saved multipliers where the clip-ReLU gate flips because the two f32
# pre-activation sums straddle 0 or 20 (the dropout decision itself must
# agree everywhere): at most this share of the elements.
GATE_FLIP_SHARE = 1e-5
# f32 gradients of one train step before clipping, as a share of each
# tensor's max.  The kernels' check holds the card's kernels against the
# plain cells run on the card: everything outside the cells is the same
# arithmetic on both sides, so they differ only by the cells' f32
# summation order carried through the backward, while a wrong kernel moves
# a gradient by its own size.  How far a few ulps carry depends on the
# tensor: the random-init flagship is badly conditioned (its backward grows
# gradients ~13 orders of magnitude over the 18 cells), and one f32 ulp of
# noise on the input audio moves the card's own gradients by up to 4.8e-2
# of a tensor's max, 3e-4 on others.  So each tensor n gets its own bound,
# read in the same call from that nudge:
#   bound[n] = min(KERNEL_GRAD_CAP, max(KERNEL_GRAD_TOL,
#                                       KERNEL_GRAD_FACTOR * nudge[n]))
# where nudge[n] is the share by which the card's 1-ulp audio nudge moves
# tensor n.  A summation order is noise of the same few-ulp size injected
# inside the cells rather than at the input, so it carries as the nudge
# does; a LayerNorm that summed its statistics in another order read
# 4.78e-2 against a nudge of 4.8e-2.  FACTOR 2 leaves room for the two
# being different draws of that noise.  The floor, 1e-3 (the bound of
# before on every tensor), holds where the step is well conditioned; the
# cap, 0.1 (TRAIN_GRAD_TOL, to which phase 11 holds the split path), is
# still 20x below a gradient moved by its own size.  The phase plants a
# fault in one cell's backward (planted_fault()) and asserts that the bound
# rejects it.  TRAIN_GRAD_TOL holds the card against the CPU, where
# cuDNN, cuBLAS and the frontend sum in other orders too, on the very
# tensor where the nudge moves the card's gradients most, by as much.  The
# phase prints those witnesses beside the checks.
TRAIN_GRAD_TOL = 0.1
KERNEL_GRAD_TOL = 1e-3
KERNEL_GRAD_FACTOR = 2.0
KERNEL_GRAD_CAP = TRAIN_GRAD_TOL
TRAIN_NORM_TOL = 1e-3


def make_cell(C, spec, device, groups=100):
    """A flagship-width cell with every parameter drawn from the seed (the
    biases and LayerNorm too, so that their indexing is tested)."""
    g = torch.Generator().manual_seed(SEED + C)
    kw = {k: v for k, v in spec.items() if k != 'arch'}
    cell = SearchCell(C, arch_vec_to_names(spec['arch']), groups=groups,
                      init_scheme='scaled', generator=g, **kw)
    with torch.no_grad():
        for name, p in cell.named_parameters():
            if name.endswith('bias'):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith('scale'):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    return cell.to(device)


def cell_ops(cell, B, T, C):
    """Conv and matmul operations of one cell forward."""
    ops = 0
    for node in cell.spec.nodes:
        if node.kind == 'conv':
            ops += 2 * B * T * C * node.K * node.cin_pg
        elif node.kind == 'linear':
            ops += 2 * B * T * C * C
    return ops


def cell_bound(cell, B, T, C, dtype, passes=2, weight_passes=1, op_factor=1):
    """(ms, 'bytes' | 'operations'): the least time for one cell call —
    ``passes`` passes over [B, T, C] in ``dtype`` (x read and y written: 2)
    with the weights moved ``weight_passes`` times, against ``op_factor`` ×
    the forward's conv and matmul operations at the dtype's peak."""
    size = torch.finfo(dtype).bits // 8
    weights, _ = cell.operands(dtype)
    nbytes = (passes * B * T * C * size
              + weight_passes * sum(w.numel() * w.element_size() for w in weights)
              + 2 * C * 4)
    ops = op_factor * cell_ops(cell, B, T, C)
    t_bytes, t_ops = nbytes / MEM_BYTES_S, ops / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def time_ms(fn, runs=30, warmup=5):
    """Median of ``runs`` CUDA-event timings of ``fn()`` after warm-up.  The
    cell input stays in the 50 MB L2 between runs, as it does in serving,
    where each cell reads what the one before it just wrote."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@torch.inference_mode()
def check_kernels(device):
    """Phase 3: kernel vs plain version at every width, spec and dtype, two
    calls bit-equal, non-finite inputs, then timings of the flagship cell.
    Returns (max errors, timing rows, the non-finite check's counts)."""
    errors = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    for C, T in WIDTHS:
        g = torch.Generator().manual_seed(SEED + T)
        x32 = torch.randn((B, T, C), generator=g).to(device)
        for name, spec in SPECS.items():
            cell = make_cell(C, spec, device)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                weights, ln = cell.operands(dtype)
                got = fused_cell.fused_cell_forward(cell.spec, x, weights, ln)
                again = fused_cell.fused_cell_forward(cell.spec, x, weights, ln)
                want = fused_cell.fused_cell_reference(cell.spec, x, weights, ln)
                torch.cuda.synchronize()
                assert torch.equal(got, again), ('two calls differ', name, C,
                                                 dtype)
                assert got.shape == want.shape and got.dtype == want.dtype
                assert bool(torch.isfinite(got.float()).all()), (name, C, dtype)
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                print(f'kernel vs plain  {name:18s} C={C:4d} T={T:3d} '
                      f'{str(dtype)[6:]:8s} max_abs_err={err:.3e} '
                      f'max|plain|={scale:.3f} tol={TOL[dtype] * scale:.3e}')
                assert err <= TOL[dtype] * scale, (name, C, dtype, err, scale)
                errors[dtype] = max(errors[dtype], err)
        cell = make_cell(C, SPECS['flagship'], device)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            args = (cell.spec, x, *cell.operands(dtype))
            ms = time_ms(lambda: fused_cell.fused_cell_forward(*args))
            dev_ms = device_ms(lambda: fused_cell.fused_cell_forward(*args))
            plain_ms = time_ms(lambda: fused_cell.fused_cell_reference(*args))
            bound_ms, bound_by = cell_bound(cell, B, T, C, dtype)
            rows.append(dict(C=C, T=T, dtype=str(dtype)[6:], ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            print(f'flagship cell  B={B} C={C:4d} T={T:3d} {str(dtype)[6:]:8s} '
                  f'kernel {ms:.4f} ms, device {dev_ms:.4f}  plain '
                  f'{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})')
    for dtype in ('float32', 'bfloat16'):
        step = train_step_sums([r for r in rows if r['dtype'] == dtype],
                               ('ms', 'device_ms', 'bound_ms'))
        print(f'fused cell forward per serving step, the 18 {dtype} cells at '
              f'B={B}: {step["ms"]:.3f} ms on CUDA events, '
              f'{step["device_ms"]:.3f} ms of device time (queued runs), '
              f'bound {step["bound_ms"]:.4f} ms')
    return errors, rows, check_forward_nonfinite(device)


def check_forward_nonfinite(device, seed=None):
    """NaN, +inf and -inf planted in x (NONFINITE) at B=4, C=600, T=300 on
    BWD_NONFINITE_SPECS, f32 and bf16: the forward kernel's outputs are NaN,
    +inf and -inf exactly where the plain version's are, run on the CPU on
    the same inputs, and its finite outputs within TOL of the finite scale.
    Without a seed the serving forward's output; with one, the training
    forward's at dropout 0.2: its output, every node output and every conv
    or linear node's multipliers.  Returns how many outputs were NaN and
    inf."""
    t0 = time.perf_counter()
    Bn, C, T = NONFINITE_SHAPE
    counts = {'nan': 0, 'inf': 0}
    g = torch.Generator().manual_seed(SEED + 19)
    x32 = torch.randn((Bn, T, C), generator=g)
    for bi, t, c, v in NONFINITE:
        x32[bi, t, c] = v
    cpu = lambda ts: ts and [t.cpu() for t in ts]
    for name in BWD_NONFINITE_SPECS:
        cell = make_cell(C, SPECS[name], device)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(device, dtype)
            weights, ln = cell.operands(dtype)
            if seed is None:
                got = [fused_cell.fused_cell_forward(cell.spec, x, weights, ln)]
                want = [fused_cell.fused_cell_reference(
                    cell.spec, x.cpu(), cpu(weights), cpu(ln))]
            else:
                spec = train_spec(cell, DROPOUT)
                y, outs, mults = fused_cell.fused_cell_train_forward(
                    spec, x, weights, ln, seed)
                ry, routs, rmults = fused_cell.fused_cell_reference(
                    spec, x.cpu(), cpu(weights), cpu(ln), seed.cpu(), save=True)
                # a zero node's multiplier slot is not written (nor read)
                live = [i for i, n in enumerate(spec.nodes) if n.kind != 'zero']
                got = [y, *outs, *mults[live]]
                want = [ry, *routs, *rmults[live]]
            for i, (a, b) in enumerate(zip(got, want)):
                a, b = a.float().cpu(), b.float()
                for test in (torch.isnan, torch.isposinf, torch.isneginf):
                    assert torch.equal(test(a), test(b)), (name, dtype, i, test)
                finite = torch.isfinite(b)
                if bool(finite.any()):
                    err = float((a[finite] - b[finite]).abs().max())
                    scale = float(b[finite].abs().max())
                    assert err <= TOL[dtype] * max(scale, 1e-30), \
                        (name, dtype, i, err, scale)
                counts['nan'] += int(torch.isnan(b).sum())
                counts['inf'] += int(torch.isinf(b).sum())
    assert counts['nan'] > 0, counts
    what = ('serving forward\'s output' if seed is None else
            'training forward\'s output, node outputs and multipliers')
    print(f'fused forward NaN/inf in x: the {what} NaN and +-inf where the '
          f'plain version\'s are ({counts["nan"]} NaN, {counts["inf"]} inf '
          f'over {2 * len(BWD_NONFINITE_SPECS)} runs), finite ones within '
          f'tolerance; {time.perf_counter() - t0:.1f} s')
    return counts


def make_audio():
    rng = np.random.RandomState(SEED)
    n = int(AUDIO_SECONDS * SAMPLE_RATE)
    audio = (rng.randn(B, n) * 0.1).astype(np.float32)
    valid = np.full(B, n, np.int64)
    valid[-1] = n - int(SHORT_BY_SECONDS * SAMPLE_RATE)
    audio[-1, valid[-1]:] = 0.0
    return audio, valid


def serve(model, audio, valid, device, block=7919, quantize=False):
    """Stream ``audio`` through StreamingASR (int8 weights with
    ``quantize``) in uneven blocks, flush and greedy-decode.  Returns
    (logits [B, n, V] numpy, tokens, lengths, device steps, wall
    seconds)."""
    if device.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = StreamingASR(model, chunk_frames=240, batch_size=B, device=device,
                     quantize=quantize)
    dec = StreamingGreedyDecoder(B)
    chunks = []
    for lo in range(0, audio.shape[1], block):
        hi = min(lo + block, audio.shape[1])
        n_valid = np.clip(valid - lo, 0, hi - lo)
        chunks += s.push(audio[:, lo:hi], n_valid)
    chunks += s.flush()
    for lg, vl in chunks:
        dec.push(lg, vl)
    logits = torch.cat([lg for lg, _ in chunks], dim=1).cpu().numpy()
    wall = time.perf_counter() - t0
    return logits, dec.tokens, s.logit_lengths, s.steps, wall


def profile_step(s, win, mask, steps=3):
    """Kernel time by name over ``steps`` device steps (torch.profiler), and
    the share of the profiled wall time the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            s._device_step(win, mask, s.hl // s.ts, s._init_carry())
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = device_kernels(prof)
    if not kernels:
        print('profile: the profiler saw no device time (not measured)')
        return
    per_step = lambda es: 1e3 * device_seconds(es) / steps
    busy = per_step(kernels)
    print(f'profile: {busy:.3f} ms of kernel time per device step, '
          f'{wall_ms:.3f} ms wall per step under the profiler '
          f'(busy {busy / wall_ms:.1%}); fused cell kernels '
          f'{per_step([e for e in kernels if "nbasr_" in e.key]):.3f} ms')
    for e in kernels[:12]:
        print(f'  {e.self_device_time_total / 1e3 / steps:8.3f} ms '
              f'{e.count // steps:5d}x  {e.key[:100]}')


def check_serving(device):
    """Phases 4-5.  Returns the kernel launches and the timings."""
    g = torch.Generator().manual_seed(SEED)
    model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                      generator=g)
    assert count_params(model) == 26_339_349, count_params(model)
    audio, valid = make_audio()

    serve(model, audio, valid, device)                     # warm-up
    fused_cell.reset_launches()
    logits, tokens, lengths, steps, wall = serve(model, audio, valid, device)
    launches = dict(fused_cell.LAUNCHES)
    print(f'serving f32: {steps} device steps, launches {launches}')
    assert launches['kernel'] == 18 * steps, (launches, steps)
    assert launches['plain'] == 0, launches
    assert logits.shape[0] == B and logits.shape[2] == 49, logits.shape
    assert logits.shape[1] >= int(lengths.max()), (logits.shape, lengths)
    assert np.isfinite(logits).all()
    audio_s = float(valid.sum()) / SAMPLE_RATE
    print(f'serving f32: wall {wall:.4f} s, {1e3 * wall / steps:.3f} ms per '
          f'device step (host included), {audio_s / wall:.1f} audio-s/s; '
          f'logit lengths {lengths.tolist()}, tokens per stream '
          f'{[len(t) for t in tokens]}')

    # one device step alone, on the card's clock
    s = StreamingASR(model, chunk_frames=240, batch_size=B, device=device)
    win = torch.randn((B, s.Wf, 80), generator=g).to(device)
    mask = torch.ones((B, s.Wf), dtype=torch.bool, device=device)
    step_ms = time_ms(lambda: s._device_step(win, mask, s.hl // s.ts,
                                             s._init_carry()), runs=20)
    print(f'device step alone: {step_ms:.3f} ms (CUDA events, median of 20)')
    profile_step(s, win, mask)

    cpu = torch.device('cpu')
    cpu_model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=cpu)
    cpu_model.load_state_dict(model.state_dict())
    want, want_tokens, want_lengths, _, cpu_wall = serve(cpu_model, audio,
                                                         valid, cpu)
    assert want.shape == logits.shape
    np.testing.assert_array_equal(lengths, want_lengths)
    err = float(np.abs(logits - want).max())
    scale = float(np.abs(want).max())
    print(f'card vs cpu f32 logits: max_abs_err={err:.3e} max|cpu|={scale:.3f} '
          f'tol={SERVE_TOL * scale:.3e} (cpu run {cpu_wall:.1f} s)')
    assert err <= SERVE_TOL * scale
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > SERVE_TOL * scale
    agree = logits.argmax(-1) == want.argmax(-1)
    print(f'greedy ids agree on {int(agree[clear].sum())}/{int(clear.sum())} '
          f'frames with a clear top-2 margin; decoded tokens equal: '
          f'{tokens == want_tokens}')
    assert agree[clear].all()

    low = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                    compute_dtype=torch.bfloat16)
    low.load_state_dict(model.state_dict())
    fused_cell.reset_launches()
    bf16, _, _, bf16_steps, bf16_wall = serve(low, audio, valid, device)
    assert fused_cell.LAUNCHES == {'kernel': 18 * bf16_steps, 'plain': 0}
    rel_l2 = float(np.linalg.norm(bf16 - logits) / np.linalg.norm(logits))
    print(f'serving bf16: wall {bf16_wall:.4f} s; vs f32 relative L2 '
          f'{rel_l2:.4f} (tol {BF16_SERVE_TOL}), max_abs_err='
          f'{float(np.abs(bf16 - logits).max()):.3e}')
    assert np.isfinite(bf16).all() and rel_l2 <= BF16_SERVE_TOL
    return launches['kernel'], dict(steps=steps, wall=wall, step_ms=step_ms)


def train_spec(cell, rate):
    """The cell's spec in training mode at dropout ``rate``."""
    s = cell.spec
    return FusedCellSpec(s.nodes, dropout_rate=rate, train=True,
                         ln_eps=s.ln_eps, use_norm=s.use_norm)


def check_masks(spec, got, want, seed, B, T, C):
    """The saved multipliers of kernel and plain version: where the hash
    drops an element both are exactly 0, and they differ nowhere else but
    at clip-ReLU gate flips.  Returns (flips, multipliers compared)."""
    flips = count = counter = 0
    thr = fused_cell.keep_threshold(spec.dropout_rate)
    for i, node in enumerate(spec.nodes):
        if node.kind == 'zero':
            continue
        if spec.dropping:
            counter += 1
            dropped = fused_cell.dropout_bits(
                seed, counter, B, T, C, c0=spec.channel_offset) >= thr
            assert not bool(got[i][dropped].any()), ('kept a dropped element', i)
            assert not bool(want[i][dropped].any()), ('kept a dropped element', i)
        flips += int((got[i] != want[i]).sum())
        count += got[i].numel()
    assert flips <= GATE_FLIP_SHARE * count, (flips, count)
    return flips, count


def backward_tensors(out):
    """The backward's outputs as one list: dx, every dW and db, dscale,
    dbias."""
    dx, dws, dln = out
    return [dx, *dws, *(dln or ())]


def grad_errors(got, want):
    """(max abs error, max error as a share of each tensor's max|plain|)
    over the backward's outputs (dx, every dW and db, dscale, dbias)."""
    dx, dws, dln = got
    rdx, rdws, rdln = want
    pairs = [(dx, rdx)] + list(zip(dws, rdws)) + list(zip(dln or (), rdln or ()))
    abs_err = rel_err = 0.0
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        assert bool(torch.isfinite(a.float()).all())
        err = float((a.float() - b.float()).abs().max())
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(float(b.float().abs().max()), 1e-30))
    return abs_err, rel_err


class TrainKernelCheck:
    """The training forward and the backward kernel against their plain
    versions on the same inputs; keeps the worst errors per dtype and the
    gate flips over every call of :meth:`check`."""

    def __init__(self, seed):
        self.seed = seed
        new = lambda: {k: {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
                       for k in ('forward', 'backward')}
        # (max abs error, max share of the scale): over every call, and over
        # the calls at the train step's own batch
        self.errors, self.step_errors = new(), new()
        self.flips = self.compared = 0

    def check(self, label, spec, x, dy, weights, ln):
        """Asserts both kernels within tolerance (the forward's output and
        its saved node outputs, the backward's outputs) and the masks
        equal; returns the kernel's (outs, mults) for reuse."""
        B, T, C = x.shape
        dtype = x.dtype
        y, outs, mults = fused_cell.fused_cell_train_forward(
            spec, x, weights, ln, self.seed)
        again = fused_cell.fused_cell_train_forward(spec, x, weights, ln,
                                                    self.seed)
        want = fused_cell.fused_cell_reference(spec, x, weights, ln, self.seed,
                                               save=True)
        torch.cuda.synchronize()
        live = [i for i, n in enumerate(spec.nodes) if n.kind != 'zero']
        assert torch.equal(y, again[0]) and torch.equal(outs, again[1]) and \
            torch.equal(mults[live], again[2][live]), \
            ('two forward calls differ', label, B, C, dtype)
        del again
        err = float((y.float() - want[0].float()).abs().max())
        scale = float(want[0].float().abs().max())
        assert err <= TOL[dtype] * scale, (label, C, dtype, err, scale)
        # every node's saved output, the last one's too (without a
        # LayerNorm it is y's), as the plain version keeps them
        assert outs.shape == want[1].shape and outs.dtype == want[1].dtype
        o_err = float((outs.float() - want[1].float()).abs().max())
        o_scale = float(want[1].float().abs().max())
        assert o_err <= TOL[dtype] * o_scale, \
            ('saved node outputs', label, C, dtype, o_err, o_scale)
        f, n = check_masks(spec, mults, want[2], self.seed, B, T, C)
        self.flips, self.compared = self.flips + f, self.compared + n
        del want
        got_b = fused_cell.fused_cell_backward(spec, x, outs, mults, dy,
                                               weights, ln)
        again = fused_cell.fused_cell_backward(spec, x, outs, mults, dy,
                                               weights, ln)
        want_b = fused_cell.fused_cell_backward_reference(spec, x, outs, mults,
                                                          dy, weights, ln)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(
            backward_tensors(got_b), backward_tensors(again))), \
            ('two backward calls differ', label, B, C, dtype)
        b_abs, b_rel = grad_errors(got_b, want_b)
        print(f'train kernels  {label:18s} B={B:2d} C={C:4d} T={T:3d} '
              f'p={spec.dropout_rate} {str(dtype)[6:]:8s} fwd err '
              f'{err / scale:.2e} of scale, node outputs '
              f'{o_err / o_scale:.2e}, gate flips {f}/{n}; bwd '
              f'max_abs_err {b_abs:.3e}, worst share {b_rel:.2e} '
              f'(tol {GRAD_TOL[dtype]:.0e})')
        assert b_rel <= GRAD_TOL[dtype], (label, B, C, dtype, b_rel)
        for errors in (self.errors, self.step_errors)[:1 + (B == TRAIN_B)]:
            for key, e in (('forward', (err, err / scale)),
                           ('backward', (b_abs, b_rel))):
                errors[key][dtype] = [max(a, b) for a, b in
                                      zip(errors[key][dtype], e)]
        return outs, mults


@torch.no_grad()
def check_train_kernels(device):
    """Phase 6.  Returns (the TrainKernelCheck with its errors and gate
    flips, the kept share, timing rows, the backward's non-finite counts,
    the training forward's non-finite counts)."""
    seed = torch.tensor(TRAIN_SEED, dtype=torch.int32, device=device)
    checker = TrainKernelCheck(seed)
    for C, T in TRAIN_WIDTHS:
        g = torch.Generator().manual_seed(SEED + C + T)
        x32 = torch.randn((CHECK_B, T, C), generator=g).to(device)
        dy32 = torch.randn((CHECK_B, T, C), generator=g).to(device)
        for name, kw in SPECS.items():
            cell = make_cell(C, kw, device)
            for rate in (0.0, DROPOUT):
                for dtype in (torch.float32, torch.bfloat16):
                    checker.check(name, train_spec(cell, rate), x32.to(dtype),
                                  dy32.to(dtype), *cell.operands(dtype))
    # groups wider than 16 channels: 50 groups of 24 at C=1200, every conv
    # kind
    C, T = TRAIN_WIDTHS[-1]
    g = torch.Generator().manual_seed(SEED + WIDE_GROUPS)
    x32 = torch.randn((CHECK_B, T, C), generator=g).to(device)
    dy32 = torch.randn((CHECK_B, T, C), generator=g).to(device)
    for name in ('flagship', 'linear+dilated', 'conv7+zero+linear'):
        cell = make_cell(C, SPECS[name], device, groups=WIDE_GROUPS)
        for dtype in (torch.float32, torch.bfloat16):
            checker.check(f'{name} ci=24', train_spec(cell, DROPOUT),
                          x32.to(dtype), dy32.to(dtype), *cell.operands(dtype))

    # kept share of one large draw: zero conv weights and bias 1 make every
    # pre-activation 1, so a multiplier is 0 exactly where dropout drops
    C, T = TRAIN_WIDTHS[0]
    cell = make_cell(C, SPECS['flagship'], device)
    for name, p in cell.named_parameters():
        if name.endswith('conv_kernel_grouped'):
            p.zero_()
        elif name.endswith('conv_bias'):
            p.fill_(1.0)
    x = torch.zeros((TRAIN_B, T, C), device=device)
    _, _, mults = fused_cell.fused_cell_train_forward(
        train_spec(cell, DROPOUT), x, *cell.operands(torch.float32), seed)
    kept = float((mults != 0).double().mean())
    sigma = (DROPOUT * (1 - DROPOUT) / mults.numel()) ** 0.5
    print(f'dropout: kept share {kept:.6f} of {mults.numel()} draws '
          f'(expected {1 - DROPOUT}, 4 sigma = {4 * sigma:.2e})')
    assert abs(kept - (1 - DROPOUT)) <= 4 * sigma

    # the train step's own shapes (B=32): checked, then timed
    rows = []
    for C, T in TRAIN_WIDTHS:
        cell = make_cell(C, SPECS['flagship'], device)
        spec = train_spec(cell, DROPOUT)
        g = torch.Generator().manual_seed(SEED + C)
        x32 = torch.randn((TRAIN_B, T, C), generator=g).to(device)
        dy32 = torch.randn((TRAIN_B, T, C), generator=g).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dtype), dy32.to(dtype)
            weights, ln = cell.operands(dtype)
            fwd = (spec, x, weights, ln, seed)
            outs, mults = checker.check('flagship', spec, x, dy, weights, ln)
            bwd = (spec, x, outs, mults, dy, weights, ln)
            n = len(spec.nodes)
            row = dict(
                C=C, T=T, B=TRAIN_B, dtype=str(dtype)[6:],
                fwd_ms=time_ms(lambda: fused_cell.fused_cell_train_forward(*fwd)),
                fwd_plain_ms=time_ms(lambda: fused_cell.fused_cell_reference(
                    *fwd, save=True), runs=10),
                fwd_device_ms=device_ms(
                    lambda: fused_cell.fused_cell_train_forward(*fwd)),
                ms=time_ms(lambda: fused_cell.fused_cell_backward(*bwd)),
                device_ms=device_ms(
                    lambda: fused_cell.fused_cell_backward(*bwd)),
                plain_ms=time_ms(
                    lambda: fused_cell.fused_cell_backward_reference(*bwd),
                    runs=10))
            row['fwd_bound_ms'], row['fwd_bound_by'] = cell_bound(
                cell, TRAIN_B, T, C, dtype, passes=2 + 2 * n)
            row['bound_ms'], row['bound_by'] = cell_bound(
                cell, TRAIN_B, T, C, dtype, passes=2 * n + 3, weight_passes=2,
                op_factor=2)
            rows.append(row)
            print(f'flagship cell train  B={TRAIN_B} C={C:4d} T={T:3d} '
                  f'{row["dtype"]:8s} forward {row["fwd_ms"]:.4f} ms, device '
                  f'{row["fwd_device_ms"]:.4f} (plain '
                  f'{row["fwd_plain_ms"]:.4f}, bound {row["fwd_bound_ms"]:.4f} '
                  f'{row["fwd_bound_by"]}); backward {row["ms"]:.4f} ms, '
                  f'device {row["device_ms"]:.4f} (plain '
                  f'{row["plain_ms"]:.4f}, bound {row["bound_ms"]:.4f} '
                  f'{row["bound_by"]})')
    for dtype in ('float32', 'bfloat16'):
        step = train_step_sums([r for r in rows if r['dtype'] == dtype],
                               ('ms', 'device_ms', 'bound_ms', 'fwd_ms',
                                'fwd_device_ms'))
        print(f'fused cell per train step, the 18 {dtype} cells at B='
              f'{TRAIN_B}: backward {step["ms"]:.3f} ms on CUDA events, '
              f'{step["device_ms"]:.3f} ms of device time (queued runs), '
              f'bound {step["bound_ms"]:.4f} ms; forward {step["fwd_ms"]:.3f} '
              f'/ {step["fwd_device_ms"]:.3f} ms')
    fwd_nonfinite = check_forward_nonfinite(device, seed)
    nonfinite = check_backward_nonfinite(device, seed)
    return checker, kept, rows, nonfinite, fwd_nonfinite


def train_step_sums(rows, keys):
    """{key: the sum over one train step's 18 cells} of one dtype's timing
    rows at the four widths (3/4/5/6 cells)."""
    return {k: sum(n * r[k] for n, r in zip(CELLS_PER_BLOCK, rows))
            for k in keys}


def check_backward_nonfinite(device, seed):
    """NaN, +inf and -inf planted in dy (NONFINITE) at B=4, C=600, T=300:
    the backward's outputs (dx, every dW and db, dscale, dbias) are NaN,
    +inf and -inf exactly where the plain version's are, run on the CPU
    on the same saved inputs, and its finite outputs within GRAD_TOL of
    the finite scale; BWD_NONFINITE_SPECS at dropout 0.2, f32 and bf16.
    Returns how many outputs were NaN and inf."""
    t0 = time.perf_counter()
    Bn, C, T = NONFINITE_SHAPE
    counts = {'nan': 0, 'inf': 0}
    g = torch.Generator().manual_seed(SEED + 17)
    x32 = torch.randn((Bn, T, C), generator=g)
    dy32 = torch.randn((Bn, T, C), generator=g)
    for bi, t, c, v in NONFINITE:
        dy32[bi, t, c] = v
    for name in BWD_NONFINITE_SPECS:
        cell = make_cell(C, SPECS[name], device)
        spec = train_spec(cell, DROPOUT)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x32.to(device, dtype), dy32.to(device, dtype)
            weights, ln = cell.operands(dtype)
            _, outs, mults = fused_cell.fused_cell_train_forward(
                spec, x, weights, ln, seed)
            got = backward_tensors(fused_cell.fused_cell_backward(
                spec, x, outs, mults, dy, weights, ln))
            cpu = lambda ts: [t.cpu() for t in ts]
            want = backward_tensors(fused_cell.fused_cell_backward_reference(
                spec, *cpu((x, outs, mults, dy)), cpu(weights), ln and cpu(ln)))
            for i, (a, b) in enumerate(zip(got, want)):
                a, b = a.float().cpu(), b.float()
                for test in (torch.isnan, torch.isposinf, torch.isneginf):
                    assert torch.equal(test(a), test(b)), (name, dtype, i, test)
                finite = torch.isfinite(b)
                if bool(finite.any()):
                    err = float((a[finite] - b[finite]).abs().max())
                    scale = float(b[finite].abs().max())
                    assert err <= GRAD_TOL[dtype] * max(scale, 1e-30), \
                        (name, dtype, i, err, scale)
                counts['nan'] += int(torch.isnan(b).sum())
                counts['inf'] += int(torch.isinf(b).sum())
    assert counts['nan'] > 0, counts
    print(f'fused backward NaN/inf in dy: outputs NaN and +-inf where the '
          f'plain version\'s are ({counts["nan"]} NaN, {counts["inf"]} inf '
          f'over {2 * len(BWD_NONFINITE_SPECS)} runs), finite ones within '
          f'tolerance; {time.perf_counter() - t0:.1f} s')
    return counts


# the fused backward's kernels (its conv dW is the grouped conv's
# nbasr_gconv_dw and nbasr_gconv_dw_reduce, built into its own library)
BWD_KERNELS = ('nbasr_ln_backward_rows', 'nbasr_ln_param_partials',
               'nbasr_reduce_chunks', 'nbasr_node_dz', 'nbasr_gconv_dw',
               'nbasr_fused_conv_dx', 'nbasr_linear_dw', 'nbasr_linear_dx',
               'nbasr_convert')
FWD_KERNELS = ('nbasr_fused_conv_fwd', 'nbasr_linear_node', 'nbasr_zero_node',
               'nbasr_layer_norm', 'nbasr_gconv_fwd')
# the flagship cell's forward kernels: its three conv nodes and the LayerNorm
FWD_LAUNCHES_PER_CELL = 4
GCONV_BWD_KERNELS = ('nbasr_gconv_dx', 'nbasr_gconv_dw')  # dw and dw_reduce


def profile_train_step(trainer, batch, lr):
    """Kernel time by name over one train step (torch.profiler), the busy
    share, and the cell kernels' part (fused cell or grouped conv).
    Returns the fused forward's kernels per cell in that step: its kernels
    in the trace (FWD_KERNELS[:4], by name) over its wrapper's launches;
    None where the step ran no fused forward or the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    cells = fused_cell.LAUNCHES['kernel']
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch, lr=lr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cells = fused_cell.LAUNCHES['kernel'] - cells
    kernels = device_kernels(prof)
    if not kernels:
        print('profile: the profiler saw no device time (not measured)')
        return None
    ms = lambda es: 1e3 * device_seconds(es)
    busy = ms(kernels)
    fwd = ms([e for e in kernels if any(k in e.key for k in FWD_KERNELS)])
    bwd = ms([e for e in kernels
              if any(k in e.key for k in BWD_KERNELS + GCONV_BWD_KERNELS)])
    print(f'train profile: {busy:.3f} ms of kernel time in one step, '
          f'{wall_ms:.3f} ms wall under the profiler (busy {busy / wall_ms:.1%}); '
          f'cell forward kernels {fwd:.3f} ms, backward kernels '
          f'{bwd:.3f} ms, rest {busy - fwd - bwd:.3f} ms')
    for e in kernels[:15]:
        print(f'  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  '
              f'{e.key[:100]}')
    if not cells:
        return None
    per_cell = sum(e.count for e in kernels
                   if any(k in e.key for k in FWD_KERNELS[:4])) / cells
    print(f'fused forward: {per_cell} kernel launches per cell in the '
          f'profiled step ({cells} cells)')
    return per_cell


def check_train_step(device, impl='auto'):
    """Phase 7 (and 11 for the grouped impls).  Returns the launch counts
    of the 5 timed steps and the timings."""
    model = get_model(FLAGSHIP, use_rnn=True, dropout_rate=DROPOUT,
                      data_norm=True, compute_dtype=torch.bfloat16,
                      device=device, grouped_impl=impl,
                      generator=torch.Generator().manual_seed(SEED))
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    batches = list(loaders[1].full)
    assert all(b['audio'].shape[0] == TRAIN_B for b in batches)
    trainer = Trainer(loaders, device=device)
    trainer.init_state(model, seed=SEED)
    lr = 1e-4
    for i in range(2):                                        # warm-up
        trainer.step(batches[i % len(batches)], lr=lr)
    steps = [batches[i % len(batches)] for i in range(5)]
    torch.cuda.synchronize()
    fused_cell.reset_launches()
    grouped_conv.reset_launches()
    ctc_pallas.reset_launches()
    t0 = time.perf_counter()
    for b in steps:
        m = trainer.step(b, lr=lr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'fused_forward': dict(fused_cell.LAUNCHES),
                'fused_backward': dict(fused_cell.BACKWARD_LAUNCHES),
                **{f'grouped_{k}': dict(v)
                   for k, v in grouped_conv.LAUNCHES.items()},
                **{f'ctc_{k}': dict(v) for k, v in ctc_pallas.LAUNCHES.items()}}
    print(f'train step [{impl}]: launches in 5 steps {launches}')
    fused = impl == 'auto'
    for name, counts in launches.items():
        if name.startswith('ctc'):
            want = 1                    # one alpha and one beta per step
        elif name.startswith('fused'):
            want = 18 if fused else 0
        else:
            want = 0 if fused else 54
        assert counts == {'kernel': want * 5, 'plain': 0}, (name, counts)
    assert np.isfinite(m['ctc_loss']) and trainer.nonfinite_steps == 0, \
        (m, trainer.nonfinite_steps)
    # audio seconds of the valid rows, as the frontend frames them
    cfg = trainer.frontend
    audio_s = sum(float((b['valid'] * ((b['feature_size'] - 1) * cfg.hop
                                       + cfg.window)).sum())
                  for b in steps) / SAMPLE_RATE
    step_ms = 1e3 * wall / len(steps)
    T = batches[0]['feature_size'].max()
    frames = loaders[1].full.bucket_frames[0]
    flops = algorithmic_flops(model, TRAIN_B, frames, train=True)
    print(f'train step [{impl}]: bf16 B={TRAIN_B} T={frames} frames (longest '
          f'{T}): {step_ms:.3f} ms per step (host clock, 5 steps), '
          f'{audio_s / wall:.1f} audio-s/s, running train loss '
          f'{m["ctc_loss"]:.4f}; {flops / 1e9:.1f} algorithmic GFLOP per step '
          f'= {flops / (step_ms / 1e3) / 1e12:.2f} TFLOP/s')
    per_cell = profile_train_step(trainer, batches[0], lr)
    if fused:   # a launch per conv node and one for the LayerNorm
        assert per_cell == FWD_LAUNCHES_PER_CELL, per_cell
    return ({k: v['kernel'] for k, v in launches.items()},
            dict(step_ms=step_ms, audio_s_per_s=audio_s / wall,
                 fwd_kernels_per_cell=per_cell))


@contextlib.contextmanager
def planted_fault(kind='bias'):
    """A witness only, never the main path: inside, the card's kernels run
    with one planted fault in the first cell backward of each step (the
    flagship's last cell), as a wrong kernel would give it: the first
    node's bias gradient negated (``kind='bias'``), or the cell's input
    gradient (``'dx'``)."""
    saved = fused_cell.fused_cell_backward
    calls = [0]

    def faulty(*args):
        dx, dweights, dln = saved(*args)
        if calls[0] == 0 and kind == 'dx':
            dx = -dx
        elif calls[0] == 0 and dweights:
            dweights = list(dweights)
            dweights[1] = -dweights[1]
        calls[0] += 1
        return dx, dweights, dln

    fused_cell.fused_cell_backward = faulty
    try:
        yield calls
    finally:
        fused_cell.fused_cell_backward = saved


def kernel_grad_bounds(nudge):
    """{tensor: the kernels' check's bound}, from the card's 1-ulp audio
    nudge's share on each tensor (see KERNEL_GRAD_FACTOR)."""
    return {n: min(KERNEL_GRAD_CAP, max(KERNEL_GRAD_TOL,
                                        KERNEL_GRAD_FACTOR * v))
            for n, v in nudge.items()}


def over_bound(shares, bounds):
    """(worst share / bound, its tensor) over the tensors."""
    name = max(shares, key=lambda n: shares[n] / bounds[n])
    return shares[name] / bounds[name], name


def check_train_cpu(device):
    """Phase 8: one f32 step's gradients before clipping, card against CPU,
    with witnesses that split the difference: the card's kernels against
    the plain cells on the card (the kernels alone), the plain cells on the
    card against the CPU (the card's other arithmetic), and each side
    against itself with the audio perturbed by one ulp (the model's
    conditioning).  Returns the readings, worst share per pair."""
    from nbasr_torch.data.phonemes import PhonemeEncoder
    model = get_model(FLAGSHIP, use_rnn=True, dropout_rate=0.0, data_norm=True,
                      device=device,
                      generator=torch.Generator().manual_seed(SEED + 1))
    cpu_model = get_model(FLAGSHIP, use_rnn=True, dropout_rate=0.0,
                          data_norm=True, device='cpu')
    cpu_model.load_state_dict(model.state_dict())
    ds = make_synthetic_split(2, seed=SEED + 5, min_samples=23000,
                              max_samples=25000)
    batch = next(iter(Loader(ds, 2)))
    nudged = dict(batch, audio=(batch['audio'] * (1 + 1e-7 * np.random.RandomState(
        SEED).randn(*batch['audio'].shape))).astype(np.float32))
    loaders = (PhonemeEncoder(48), None, None, None)

    def gradients(trainer, m, b):
        trainer.init_state(m, seed=SEED)       # the same dropout masks
        grads, metrics = trainer.gradients(b)
        return {k: v.cpu() for k, v in grads.items()}, metrics

    t0 = time.perf_counter()
    card = Trainer(loaders, device=device)
    got, got_m = gradients(card, model, batch)
    got_nudged, _ = gradients(card, model, nudged)
    with plain_cells():
        fused_cell.reset_launches()
        plain, _ = gradients(card, model, batch)
        assert fused_cell.LAUNCHES['kernel'] == 0 and \
            fused_cell.BACKWARD_LAUNCHES['kernel'] == 0
    with planted_fault() as calls:
        faulty, _ = gradients(card, model, batch)
        assert calls[0] == 18, calls
    host = Trainer(loaders, device='cpu')
    want, want_m = gradients(host, cpu_model, batch)
    near, _ = gradients(host, cpu_model, nudged)
    cpu_s = time.perf_counter() - t0
    assert got.keys() == want.keys() and len(want) == len(list(model.parameters()))

    def shares(a, ref):
        out = {}
        for name, w in ref.items():
            assert bool(torch.isfinite(a[name]).all()), name
            out[name] = float((a[name] - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
        return out

    pairs = {'card vs cpu': shares(got, want),
             'kernels vs plain cells, both on the card': shares(got, plain),
             'planted fault vs plain cells, both on the card':
                 shares(faulty, plain),
             'plain cells on the card vs cpu': shares(plain, want),
             'card vs card, audio nudged 1e-7': shares(got_nudged, got),
             'cpu vs cpu, audio nudged 1e-7': shares(near, want)}
    norm = lambda gs: float(torch.sqrt(sum(v.double().square().sum()
                                           for v in gs.values())))
    n_card, n_cpu = norm(got), norm(want)
    print(f'card vs cpu f32 train step (B=2, {batch["feature_size"].tolist()} '
          f'frames, cell dropout {DROPOUT}, same masks): loss '
          f'{got_m["ctc_loss"]:.6f} vs {want_m["ctc_loss"]:.6f}; global norm '
          f'{n_card:.6e} vs {n_cpu:.6e} (tol {TRAIN_NORM_TOL} relative); '
          f'{len(want)} tensors; {cpu_s:.1f} s')
    readings = {}
    bounds = kernel_grad_bounds(pairs['card vs card, audio nudged 1e-7'])
    for label, s in pairs.items():
        worst = max(s, key=s.get)
        readings[label] = s[worst]
        tol = f' (tol {TRAIN_GRAD_TOL:.0e})' if label == 'card vs cpu' else ''
        print(f'  gradient error as a share of each tensor\'s max, {label}: '
              f'worst {s[worst]:.2e} ({worst}), median '
              f'{np.median(list(s.values())):.2e}{tol}')
    top = sorted(pairs['card vs cpu'], key=pairs['card vs cpu'].get,
                 reverse=True)[:4]
    print('  worst tensors (card vs cpu / kernels vs plain / card nudged / '
          'cpu nudged): ' + ', '.join(
              f'{n} ' + '/'.join(f'{pairs[k][n]:.2e}' for k in (
                  'card vs cpu', 'kernels vs plain cells, both on the card',
                  'card vs card, audio nudged 1e-7',
                  'cpu vs cpu, audio nudged 1e-7')) for n in top))
    honest, honest_at = over_bound(
        pairs['kernels vs plain cells, both on the card'], bounds)
    planted, planted_at = over_bound(
        pairs['planted fault vs plain cells, both on the card'], bounds)
    raised = sum(b > KERNEL_GRAD_TOL for b in bounds.values())
    print(f'  kernels check, bound per tensor min({KERNEL_GRAD_CAP:g}, max('
          f'{KERNEL_GRAD_TOL:g}, {KERNEL_GRAD_FACTOR:g} x card nudge)): '
          f'bounds {min(bounds.values()):.2e} to {max(bounds.values()):.2e} '
          f'({raised} of {len(bounds)} above the floor); kernels at '
          f'{honest:.3f} of their bound ({honest_at}: '
          f'{pairs["kernels vs plain cells, both on the card"][honest_at]:.2e}'
          f' against {bounds[honest_at]:.2e}): passed; planted fault at '
          f'{planted:.1f} of its bound ({planted_at}: '
          f'{pairs["planted fault vs plain cells, both on the card"][planted_at]:.2e}'
          f' against {bounds[planted_at]:.2e}): rejected')
    assert planted > 1.0, ('the kernels check passed a planted fault',
                           planted_at, planted)
    assert honest <= 1.0, ('kernels vs plain cells', honest_at, honest)
    assert readings['card vs cpu'] <= TRAIN_GRAD_TOL
    assert abs(n_card - n_cpu) <= TRAIN_NORM_TOL * n_cpu
    readings['kernels_over_bound'] = honest
    readings['planted_fault_over_bound'] = planted
    readings['kernel_bound_range'] = [min(bounds.values()), max(bounds.values())]
    return readings


# ---------------------------------------------------------------------------
# phases 9-11: the grouped conv kernels ('pallas', 'pallas_split')
# ---------------------------------------------------------------------------

GROUPS = 100
GCONV_KD = ((5, 1), (5, 2), (7, 1), (7, 2))
GCONV_LAYOUTS = ('dense', 'split')       # a strided split view; contiguous
GCONV_KERNELS = ('forward', 'dx', 'dw')
GCONV_SOURCE = 'nbasr_torch/csrc/grouped_conv.cu'
GCONV_REPLACES = {
    'forward': 'nbasr_tpu/ops/grouped_conv.py:39 (_fwd_kernel, pallas_call '
               ':138); nbasr_tpu/ops/cell_ops.py:59 (_fwd_kernel, '
               'pallas_call :124)',
    'dx': 'nbasr_tpu/ops/grouped_conv.py:56 (_dx_kernel, pallas_call :182); '
          'nbasr_tpu/ops/cell_ops.py:78 (_dx_kernel, pallas_call :171)',
    'dw': 'nbasr_tpu/ops/grouped_conv.py:79 (_dw_kernel, pallas_calls '
          'grouped_conv.py:204 and cell_ops.py:192)'}
GCONV_CHECKED_AT = ('B=4 at (C, T) = (600, 300), (800, 300), (1000, 150), '
                    '(1200, 75), K/d 5/1, 5/2, 7/1, 7/2, and B=32 with K/d 5/1; '
                    'a dense tensor as a strided split view and a contiguous '
                    'split tensor; forward without and with the bias + '
                    'clip-ReLU epilogue; f32 and bf16')
# The kernels beyond the flagship's shapes, (B, T, G, ci, co, K, d): groups
# of 24 (G=50 at C=1200), of one channel, T shorter than the halo, B=1, T
# not a multiple of the row tile, taps and outputs past the register tile,
# one group of 800 (cell_groups=1 at C=800, d=2: more output tiles than a
# forward or dx block has threads for at once), and ci != co (the dx's
# staged dz and its output differ in width, its weights transposed)
GCONV_EDGES = ((4, 75, 50, 24, 24, 5, 1), (4, 75, 100, 1, 1, 5, 1),
               (4, 3, 100, 6, 6, 7, 2), (1, 300, 100, 6, 6, 5, 1),
               (4, 77, 100, 12, 12, 7, 2), (2, 10, 3, 30, 30, 9, 1),
               (2, 20, 1, 800, 800, 5, 2), (4, 75, 100, 6, 12, 5, 1))
GCONV_EDGES_CHECKED_AT = (
    f'; also at (B, T, G, ci, co, K, d) = {", ".join(map(str, GCONV_EDGES))} '
    'on both layouts and a [B, G, T, c] view (g strided); two calls '
    'bit-equal at every shape')
GCONV_NONFINITE_AT = (
    ' (B=4, C=600, T=300, K/d 5/1 and 7/2, both layouts) give NaN and +-inf '
    'where the plain version does')
GCONV_DW_CHECKED_AT = GCONV_CHECKED_AT + GCONV_EDGES_CHECKED_AT
GCONV_FWD_CHECKED_AT = (
    GCONV_CHECKED_AT + GCONV_EDGES_CHECKED_AT + ', both epilogues; NaN, '
    '+inf and -inf inputs' + GCONV_NONFINITE_AT + ', both epilogues')
GCONV_DX_CHECKED_AT = (
    GCONV_CHECKED_AT + GCONV_EDGES_CHECKED_AT + ', and at each edge shape '
    'on a dz expanded along T (stride 0); NaN, +inf and -inf in dz'
    + GCONV_NONFINITE_AT)
# The non-finite checks at (B, C, T) = NONFINITE_SHAPE: (b, t, channel,
# value) planted in x (the forward) or dz (dx), in three utterances, so no
# window holds two of them.
NONFINITE_SHAPE = (4, 600, 300)
NONFINITE = ((1, 10, 7, float('nan')), (2, 100, 250, float('inf')),
             (3, 200, 433, float('-inf')))
# The flagship's logits with the grouped conv kernels against the fused cell
# kernels, both f32 on the card, as a share of max|fused|: the two sum each
# conv node in another order and round at other points (the fused cell in
# one f32 pass per node, the grouped paths at each op), through 18 cells.
GROUPED_LOGITS_TOL = 1e-3
# Kernels against plain versions, f32 step gradients, per configuration.
# 'pallas' is held to KERNEL_GRAD_TOL.  'pallas_split' cannot be: its gate
# comes from the rounded output and passes nothing at exactly 0, and the
# random-init flagship's backward turns the conv sums' order into up to
# 4.78e-2 of a tensor's max (measured on an H100: the same reading as the
# card's 1-ulp audio nudge of phase 8, on the same tensor; on the CPU,
# 1e-7 relative noise on every split conv output moves the gradients by
# 2.8e-2, on 'pallas' by 1.8e-2 with the 'he' init).  It is held to
# TRAIN_GRAD_TOL, which a wrong kernel (off by its own size) still fails,
# and the phase prints the split path's own 1-ulp audio nudge beside it.
STEP_KERNEL_TOL = {'pallas': KERNEL_GRAD_TOL, 'pallas_split': TRAIN_GRAD_TOL}


def _gconv_operands(C, T, Bn, K, d, dtype, device, g):
    """x, dz (dense [Bn, T, C]), w [K, ci, C] and bias [C] in ``dtype``."""
    ci = C // GROUPS
    x = torch.randn((Bn, T, C), generator=g)
    dz = torch.randn((Bn, T, C), generator=g)
    w = torch.randn((K, ci, C), generator=g) / (K * ci) ** 0.5
    b = 0.1 * torch.randn((C,), generator=g)
    return [t.to(device=device, dtype=dtype) for t in (x, dz, w, b)]


def _gconv_args(x, dz, layout):
    """The split views the kernels take: of the dense tensors themselves,
    or contiguous copies; and where each output goes."""
    xs, zs = to_split(x, GROUPS), to_split(dz, GROUPS)
    if layout == 'split':
        return xs.contiguous(), zs.contiguous(), torch.empty_like(
            xs, memory_format=torch.contiguous_format), torch.empty_like(
            xs, memory_format=torch.contiguous_format)
    return xs, zs, to_split(torch.empty_like(x), GROUPS), to_split(
        torch.empty_like(x), GROUPS)


def _gconv_calls(xs, zs, w, b, lpad, d, y, dx, fns):
    """{kernel: zero-argument call} for the epilogue-free forward, the
    forward with bias + clip-ReLU, dx and dW through ``fns`` (the kernels'
    wrappers or their plain versions)."""
    fwd, dxf, dwf = fns
    return {'forward': lambda: fwd(xs, w, None, lpad, d, y),
            'forward+bias': lambda: fwd(xs, w, b, lpad, d, y),
            'dx': lambda: dxf(zs, w, lpad, d, dx),
            'dw': lambda: dwf(xs, zs, w, lpad, d)}


KERNEL_FNS = (grouped_conv._launch_forward, grouped_conv._launch_dx,
              grouped_conv._launch_dw)
PLAIN_FNS = (grouped_conv.conv_forward_reference,
             grouped_conv.conv_dx_reference, grouped_conv.conv_dw_reference)


def _gconv_compare(calls, plain, errors, label):
    """Runs each kernel and its plain version on the same inputs; asserts
    the error within TOL (forward) or GRAD_TOL (dx, dW) of max|plain|."""
    for name in calls:
        got = calls[name]().float().clone()
        # one owner per sum, each in a fixed order
        assert torch.equal(calls[name]().float(), got), (label, name, 'bits')
        want = plain[name]().float()
        torch.cuda.synchronize()
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        dtype = label[-1]
        tol = (TOL if name.startswith('forward') else GRAD_TOL)[dtype]
        assert err <= tol * scale, (label, name, err, scale)
        key = name.split('+')[0]
        e = errors[key][dtype]
        errors[key][dtype] = [max(e[0], err), max(e[1], err / scale)]


def gconv_bound(C, T, Bn, K, dtype, name):
    """(ms, 'bytes' | 'operations') for one node: each input read once and
    each output written once (two [Bn, T, C] passes, the weight, and the
    bias for the split forward or dW for the weight gradient) against
    2*Bn*T*C*K*ci operations at the dtype's peak."""
    size = torch.finfo(dtype).bits // 8
    ci = C // GROUPS
    nbytes = (2 * Bn * T * C + K * ci * C + (C if name == 'forward+bias' else 0)
              ) * size
    t_bytes = nbytes / MEM_BYTES_S
    t_ops = 2 * Bn * T * C * K * ci / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def _library_calls(x, dz, w, lpad, d):
    """One cuDNN call per function on inputs already in its layout
    ([B, C, T], the input padded): timed as yardsticks, never on a path."""
    K = w.shape[0]
    xp = torch.nn.functional.pad(x.transpose(1, 2), (lpad, (K - 1) * d - lpad)
                                 ).contiguous()
    zt = dz.transpose(1, 2).contiguous()
    wt = w.permute(2, 1, 0).contiguous()
    return {'forward': lambda: torch.nn.functional.conv1d(
                xp, wt, dilation=d, groups=GROUPS),
            'dx': lambda: torch.nn.grad.conv1d_input(
                xp.shape, wt, zt, dilation=d, groups=GROUPS),
            'dw': lambda: torch.nn.grad.conv1d_weight(
                xp, wt.shape, zt, dilation=d, groups=GROUPS)}


def _layout_view(t, G, layout):
    """The [B, c, T, G] view of a dense [B, T, G*c] tensor in ``layout``:
    the tensor itself, a contiguous split copy, or a copy in [B, G, T, c]
    memory (g not contiguous: staged element by element)."""
    if layout == 'dense':
        return to_split(t, G)
    if layout == 'split':
        return to_split(t, G).contiguous()
    Bn, T, C = t.shape
    return t.reshape(Bn, T, G, C // G).permute(0, 2, 1, 3).contiguous(
        ).permute(0, 3, 2, 1)


def check_edges(device, errors):
    """The forward (both epilogues), dx and dW kernels against their plain
    versions, and two calls bit-equal, at GCONV_EDGES on both layouts and
    on a view whose groups are not contiguous, and dx on a dz expanded
    along T (autograd's gradient of a sum, stride 0), in f32 and bf16."""
    for Bn, T, G, ci, co, K, d in GCONV_EDGES:
        lpad, _ = conv_padding(K, d, 1)
        g = torch.Generator().manual_seed(SEED + Bn + T + ci)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((Bn, T, G * ci), generator=g).to(device, dtype)
            dz = torch.randn((Bn, T, G * co), generator=g).to(device, dtype)
            w = (torch.randn((K, ci, G * co), generator=g) / (K * ci) ** 0.5
                 ).to(device, dtype)
            b = (0.1 * torch.randn((G * co,), generator=g)).to(device, dtype)
            for layout in GCONV_LAYOUTS + ('strided',):
                xs, zs = _layout_view(x, G, layout), _layout_view(dz, G, layout)
                y = _layout_view(torch.empty_like(dz), G, layout)
                dx = _layout_view(torch.empty_like(x), G, layout)
                calls = _gconv_calls(xs, zs, w, b, lpad, d, y, dx, KERNEL_FNS)
                plain = _gconv_calls(xs, zs, w, b, lpad, d, y.clone(),
                                     dx.clone(), PLAIN_FNS)
                _gconv_compare(calls, plain, errors,
                               (Bn, T, G, ci, co, K, d, layout, dtype))
            zs = to_split(dz[:, :1].expand(dz.shape), G)     # stride 0 along T
            dx = to_split(torch.empty_like(x), G)
            _gconv_compare(
                {'dx': lambda: grouped_conv._launch_dx(zs, w, lpad, d, dx)},
                {'dx': lambda: grouped_conv.conv_dx_reference(
                    zs, w, lpad, d, dx.clone())},
                errors, (Bn, T, G, ci, co, K, d, 'expanded', dtype))
    for k in GCONV_KERNELS:
        e = errors[k]
        print(f'grouped conv {k:8s} kernel vs plain and bit-equal across two '
              f'calls at {len(GCONV_EDGES)} edge shapes too: f32 share '
              f'{e[torch.float32][1]:.2e}, bf16 {e[torch.bfloat16][1]:.2e}')


def check_nonfinite(device):
    """NaN, +inf and -inf planted in x (NONFINITE) for the forward and in
    dz for dx: the kernels' outputs are NaN, +inf and -inf exactly where
    the plain version's are (run on the CPU, whose direct convolution puts
    them only where a window holds one), their finite outputs within TOL
    (the forward) or GRAD_TOL (dx); both layouts, the forward's two
    epilogues, f32 and bf16.  Returns {kernel: how many outputs were NaN
    and inf}."""
    Bn, C, T = NONFINITE_SHAPE
    counts = {k: {'nan': 0, 'inf': 0} for k in ('forward', 'dx')}
    runs = dict.fromkeys(counts, 0)
    for K, d in ((5, 1), (7, 2)):
        lpad, _ = conv_padding(K, d, 1)
        g = torch.Generator().manual_seed(SEED + 13 * K + d)
        x, dz, w, b = _gconv_operands(C, T, Bn, K, d, torch.float32, 'cpu', g)
        for bi, t, c, v in NONFINITE:
            x[bi, t, c] = v
            dz[bi, t, c] = v
        for dtype in (torch.float32, torch.bfloat16):
            wc = w.to(dtype)
            for layout in GCONV_LAYOUTS:
                cases = [('forward', x, bias) for bias in (None, b)]
                cases.append(('dx', dz, None))
                for name, src, bias in cases:
                    sc = src.to(dtype)
                    bc = None if bias is None else bias.to(dtype)
                    out = torch.empty((Bn, C // GROUPS, T, GROUPS), dtype=dtype)
                    ss = _layout_view(sc.to(device), GROUPS, layout)
                    o = _layout_view(torch.empty_like(sc, device=device),
                                     GROUPS, layout)
                    if name == 'forward':
                        want = grouped_conv.conv_forward_reference(
                            to_split(sc, GROUPS), wc, bc, lpad, d, out)
                        got = grouped_conv._launch_forward(
                            ss, wc.to(device),
                            None if bc is None else bc.to(device), lpad, d, o)
                    else:
                        want = grouped_conv.conv_dx_reference(
                            to_split(sc, GROUPS), wc, lpad, d, out)
                        got = grouped_conv._launch_dx(ss, wc.to(device), lpad,
                                                      d, o)
                    got, want = got.float().cpu(), want.float()
                    label = (name, K, d, dtype, layout, bias is not None)
                    for test in (torch.isnan, torch.isposinf, torch.isneginf):
                        assert torch.equal(test(got), test(want)), (label, test)
                    finite = torch.isfinite(want)
                    err = float((got[finite] - want[finite]).abs().max())
                    scale = float(want[finite].abs().max())
                    tol = (TOL if name == 'forward' else GRAD_TOL)[dtype]
                    assert err <= tol * scale, (label, err, scale)
                    counts[name]['nan'] += int(torch.isnan(want).sum())
                    counts[name]['inf'] += int(torch.isinf(want).sum())
                    runs[name] += 1
    for name, n in counts.items():
        assert n['nan'] > 0 and n['inf'] > 0, (name, n)
        print(f'grouped conv {name:8s} NaN/inf inputs: outputs NaN and +-inf '
              f'where the plain version\'s are ({n["nan"]} NaN, {n["inf"]} '
              f'inf over {runs[name]} runs), finite ones within tolerance')
    return counts


# Cycles of torch.cuda._sleep before a queued timing (~10 ms on an H100):
# long enough for the host to enqueue every call of the run behind it.
QUEUE_SPIN_CYCLES = 20_000_000


def device_ms(fn, runs=20):
    """Device time per call of ``runs`` calls of ``fn``, back to back, CUDA
    events around them.  The calls are queued behind a spin kernel, so the
    card runs them one after another without waiting for the host; unlike
    ``time_ms`` this leaves out the wrappers' host time, which a lone call
    on an idle card waits for.  Where the card finished before the host had
    queued every call, the run is repeated behind a spin four times as
    long."""
    fn()
    torch.cuda.synchronize()
    spin = QUEUE_SPIN_CYCLES
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        queued = not end.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / runs
        spin *= 4
        assert spin <= 64 * QUEUE_SPIN_CYCLES, \
            'the host did not queue the run in time'



@torch.no_grad()
def check_gconv_kernels(device):
    """Phase 9.  Returns ({kernel: {dtype: [max abs err, max share]}},
    timing rows at the train step's B=32, the non-finite check's
    counts)."""
    errors = {k: {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
              for k in GCONV_KERNELS}
    for C, T in TRAIN_WIDTHS:
        g = torch.Generator().manual_seed(SEED + 7 * C + T)
        for K, d in GCONV_KD:
            lpad, _ = conv_padding(K, d, 1)
            for dtype in (torch.float32, torch.bfloat16):
                x, dz, w, b = _gconv_operands(C, T, CHECK_B, K, d, dtype,
                                              device, g)
                for layout in GCONV_LAYOUTS:
                    xs, zs, y, dx = _gconv_args(x, dz, layout)
                    _gconv_compare(
                        _gconv_calls(xs, zs, w, b, lpad, d, y, dx, KERNEL_FNS),
                        _gconv_calls(xs, zs, w, b, lpad, d, y.clone(),
                                     dx.clone(), PLAIN_FNS),
                        errors, (C, T, CHECK_B, K, d, layout, dtype))
    for k, e in errors.items():
        print(f'grouped conv {k:8s} kernel vs plain, B=4, all widths, K/d, '
              f'layouts: f32 max_abs_err {e[torch.float32][0]:.3e} '
              f'(share {e[torch.float32][1]:.2e}), bf16 '
              f'{e[torch.bfloat16][0]:.3e} (share {e[torch.bfloat16][1]:.2e})')
    check_edges(device, errors)
    nonfinite = check_nonfinite(device)

    rows = []
    K, d = 5, 1                         # the flagship's conv5 nodes
    lpad, _ = conv_padding(K, d, 1)
    for C, T in TRAIN_WIDTHS:
        g = torch.Generator().manual_seed(SEED + 11 * C)
        for dtype in (torch.float32, torch.bfloat16):
            x, dz, w, b = _gconv_operands(C, T, TRAIN_B, K, d, dtype, device, g)
            library = _library_calls(x, dz, w, lpad, d)
            for layout in GCONV_LAYOUTS:
                xs, zs, y, dx = _gconv_args(x, dz, layout)
                calls = _gconv_calls(xs, zs, w, b, lpad, d, y, dx, KERNEL_FNS)
                plain = _gconv_calls(xs, zs, w, b, lpad, d, y.clone(),
                                     dx.clone(), PLAIN_FNS)
                _gconv_compare(calls, plain, errors,
                               (C, T, TRAIN_B, K, d, layout, dtype))
                # the path's forward: 'pallas' without, 'pallas_split' with
                # the epilogue
                fwd = 'forward' if layout == 'dense' else 'forward+bias'
                for name in (fwd, 'dx', 'dw'):
                    key = name.split('+')[0]
                    bound_ms, bound_by = gconv_bound(C, T, TRAIN_B, K, dtype,
                                                     name)
                    row = dict(kernel=key, layout=layout, C=C, T=T, B=TRAIN_B,
                               dtype=str(dtype)[6:],
                               ms=time_ms(calls[name]),
                               plain_ms=time_ms(plain[name], runs=10),
                               library_ms=time_ms(library[key]),
                               bound_ms=bound_ms, bound_by=bound_by)
                    note = ''
                    if dtype == torch.bfloat16:
                        row['device_ms'] = device_ms(calls[name])
                        row['library_device_ms'] = device_ms(library[key])
                        note = (f'; device time {row["device_ms"]:.4f}, '
                                  f'cuDNN {row["library_device_ms"]:.4f}')
                    rows.append(row)
                    print(f'grouped conv {key:8s} {layout:5s} B={TRAIN_B} '
                          f'C={C:4d} T={T:3d} {row["dtype"]:8s} kernel '
                          f'{row["ms"]:.4f} ms  plain {row["plain_ms"]:.4f}  '
                          f'cuDNN {row["library_ms"]:.4f}  bound '
                          f'{bound_ms:.4f} ({bound_by}){note}')
    keys = ('ms', 'library_ms', 'device_ms', 'library_device_ms', 'bound_ms')
    for name in GCONV_KERNELS:
        for layout in GCONV_LAYOUTS:
            step = gconv_step_sums(rows, name, layout, keys)
            print(f'grouped conv {name} per train step, {layout}: the '
                  f'9/12/15/18 bf16 nodes of the four widths: kernel '
                  f'{step["ms"]:.3f} ms, cuDNN {step["library_ms"]:.3f} ms '
                  f'(one call each, CUDA events); device time '
                  f'{step["device_ms"]:.3f} ms, cuDNN '
                  f'{step["library_device_ms"]:.3f} ms (queued runs); bound '
                  f'{step["bound_ms"]:.4f} ms; events minus device time '
                  f'{1e3 * (step["ms"] - step["device_ms"]) / 54:.1f} us a '
                  f'call, cuDNN '
                  f'{1e3 * (step["library_ms"] - step["library_device_ms"]) / 54:.1f}')
    return errors, rows, nonfinite


def _flagship_features(Bn, frames, seed):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((Bn, frames, 80), generator=g)
    sizes = torch.full((Bn,), frames, dtype=torch.int32)
    sizes[-1] = frames - frames // 5
    return feats, sizes


def native_state(state):
    """A state dict of grouped cell kernels in ``'native'``'s ``nn.Conv``
    layout: ``conv_kernel_grouped [K, ci, C]`` -> ``conv.weight [C, ci,
    K]``, ``conv_bias`` -> ``conv.bias``."""
    out = {}
    for k, v in state.items():
        if k.endswith('.conv_kernel_grouped'):
            out[k[:-len('conv_kernel_grouped')] + 'conv.weight'] = \
                v.permute(2, 1, 0).contiguous()
        elif k.endswith('.conv_bias'):
            out[k[:-len('conv_bias')] + 'conv.bias'] = v
        else:
            out[k] = v
    return out


# The JAX package's XLA lowerings (stock PyTorch in the port: cuDNN convs
# and einsum-expanded kernels), and the tap-matmul block conv, held against
# the fused flagship's logits in phase 10
XLA_IMPLS = ('chunked', 'masked_dense', 'native')


@torch.no_grad()
def check_grouped_forward(device):
    """Phase 10.  Returns ({impl: (worst share of max|fused|, grouped
    forward launches)} of 'pallas' and 'pallas_split', {option: (share,
    fused cell launches)} of the XLA lowerings and tap_matmul)."""
    fused = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                      generator=torch.Generator().manual_seed(SEED + 2))
    feats, sizes = _flagship_features(CHECK_B, TRAIN_WIDTHS[0][1], SEED + 3)
    feats, sizes = feats.to(device), sizes.to(device)
    want = fused(feats, sizes)
    scale = float(want.abs().max())
    options = {}
    for impl in XLA_IMPLS + ('tap_matmul',):
        kw = ({'block_conv_impl': 'tap_matmul'} if impl == 'tap_matmul'
              else {'grouped_impl': impl})
        model = get_model(FLAGSHIP, use_rnn=True, data_norm=True,
                          device=device, **kw)
        state = fused.state_dict()
        model.load_state_dict(native_state(state) if impl == 'native'
                              else state)
        grouped_conv.reset_launches()
        fused_cell.reset_launches()
        got = model(feats, sizes)
        torch.cuda.synchronize()
        cells = fused_cell.LAUNCHES['kernel']
        assert all(v == {'kernel': 0, 'plain': 0}
                   for v in grouped_conv.LAUNCHES.values())
        assert fused_cell.LAUNCHES['plain'] == 0
        # the lowerings run no kernel of ours; tap_matmul keeps the fused
        # cells, 18 launches
        assert cells == (18 if impl == 'tap_matmul' else 0), (impl, cells)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        print(f'{"block conv" if impl == "tap_matmul" else "cell lowering"} '
              f'[{impl}]: f32 logits vs fused on the card, B={CHECK_B} '
              f'T={TRAIN_WIDTHS[0][1]}: max_abs_err {err:.3e}, max|fused| '
              f'{scale:.3f} (tol {GROUPED_LOGITS_TOL * scale:.3e}); fused '
              f'cell launches {cells}')
        assert err <= GROUPED_LOGITS_TOL * scale, (impl, err, scale)
        options[impl] = (err / scale, cells)
    out = {}
    for impl in ('pallas', 'pallas_split'):
        model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                          grouped_impl=impl)
        model.load_state_dict(fused.state_dict())
        grouped_conv.reset_launches()
        fused_cell.reset_launches()
        got = model(feats, sizes)
        torch.cuda.synchronize()
        launches = {k: dict(v) for k, v in grouped_conv.LAUNCHES.items()}
        assert launches['forward'] == {'kernel': 54, 'plain': 0}, launches
        assert fused_cell.LAUNCHES['kernel'] == 0
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        print(f'grouped forward [{impl}]: f32 logits vs fused on the card, '
              f'B={CHECK_B} T={TRAIN_WIDTHS[0][1]}: max_abs_err {err:.3e}, '
              f'max|fused| {scale:.3f} (tol {GROUPED_LOGITS_TOL * scale:.3e}); '
              f'launches {launches}')
        assert err <= GROUPED_LOGITS_TOL * scale, (impl, err, scale)
        out[impl] = (err / scale, launches['forward']['kernel'])
    return out, options


def _step_grads(impl, device, state, batch, loaders):
    """One f32 step's gradients before clipping on ``device`` (cell dropout
    0.2, the masks of ``init_state(seed=SEED)``)."""
    model = get_model(FLAGSHIP, use_rnn=True, dropout_rate=0.0, data_norm=True,
                      device=device, grouped_impl=impl)
    model.load_state_dict(state)
    trainer = Trainer(loaders, device=device)
    trainer.init_state(model, seed=SEED)
    grads, metrics = trainer.gradients(batch)
    return {k: v.cpu() for k, v in grads.items()}, metrics


def _worst_share(got, want):
    shares = {}
    for name, w in want.items():
        assert bool(torch.isfinite(got[name]).all()), name
        shares[name] = float((got[name] - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
    worst = max(shares, key=shares.get)
    return shares[worst], worst, float(np.median(list(shares.values())))


def check_grouped_grads(device):
    """Phase 11, gradients.  Returns the worst shares per reading."""
    from nbasr_torch.data.phonemes import PhonemeEncoder
    state = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device='cpu',
                      generator=torch.Generator().manual_seed(SEED + 1)
                      ).state_dict()
    ds = make_synthetic_split(2, seed=SEED + 5, min_samples=23000,
                              max_samples=25000)
    batch = next(iter(Loader(ds, 2)))
    nudged = dict(batch, audio=(batch['audio'] * (1 + 1e-7 * np.random.RandomState(
        SEED).randn(*batch['audio'].shape))).astype(np.float32))
    loaders = (PhonemeEncoder(48), None, None, None)
    fused, _ = _step_grads('auto', device, state, batch, loaders)
    readings = {}
    for impl in ('pallas', 'pallas_split'):
        grouped_conv.reset_launches()
        got, m = _step_grads(impl, device, state, batch, loaders)
        assert all(v == {'kernel': 54, 'plain': 0}
                   for v in grouped_conv.LAUNCHES.values()), grouped_conv.LAUNCHES
        with plain_convs():
            grouped_conv.reset_launches()
            plain, _ = _step_grads(impl, device, state, batch, loaders)
            assert all(v == {'kernel': 0, 'plain': 54}
                       for v in grouped_conv.LAUNCHES.values())
            plain_nudged, _ = _step_grads(impl, device, state, nudged, loaders)
        pairs = {'kernels vs plain versions, both on the card':
                 _worst_share(got, plain),
                 'plain versions vs themselves, audio nudged 1e-7':
                 _worst_share(plain_nudged, plain),
                 'vs the fused cell on the card': _worst_share(got, fused)}
        for label, (worst, name, median) in pairs.items():
            tol = (f' (tol {STEP_KERNEL_TOL[impl]:.0e})'
                   if label.startswith('kernels') else ' (witness)')
            print(f'grouped grads [{impl}] f32 step, B=2, cell dropout '
                  f'{DROPOUT}, loss {m["ctc_loss"]:.6f}: {label}: worst '
                  f'{worst:.2e} ({name}), median {median:.2e}{tol}')
            readings[f'{impl}: {label}'] = worst
        assert pairs['kernels vs plain versions, both on the card'][0] <= \
            STEP_KERNEL_TOL[impl], impl
    return readings


# ---------------------------------------------------------------------------
# phases 12-13: the CTC kernels, and the eval pass with beam search
# ---------------------------------------------------------------------------

CTC_SOURCE = 'nbasr_torch/csrc/ctc.cu'
CTC_REPLACES = {
    'alpha': 'nbasr_tpu/ops/ctc_pallas.py:42 (_alpha_kernel, pallas_call :69)',
    'beta': 'nbasr_tpu/ops/ctc_pallas.py:88 (_beta_kernel, pallas_call :114)'}
VOCAB = 49
# Stacks, kernel against plain version on the card: finite entries within
# the JAX package's tolerance for its Pallas kernels against its scans
# (tests/test_ctc_pallas.py:40), since the two run the same f32 recursion
# and differ by expf/logf against torch's exp/log, carried over T steps;
# entries at or below CTC_FLOOR (-1e30 and -inf) floored on both sides.
CTC_RTOL, CTC_ATOL, CTC_FLOOR = 1e-5, 1e-4, -1e29
# The loss and its logits gradient, kernels against plain versions on the
# card, as a share of max|plain|: the same arithmetic around the recursions.
CTC_LOSS_TOL = 1e-5
# F.ctc_loss, a witness: the same log-space algorithm, summed in other
# orders (its own log-sum-exp, the gradient through autograd's
# log-softmax).  Losses within 1e-4 relative.  The gradient's posterior
# exp(alpha + beta - ll) carries each side's own f32 rounding of
# log-probabilities summed over T frames (|alpha| reaches ~1e3, where an
# ulp is 6e-5): on the CPU the two differ by 5.7e-4 of the scale at T=320,
# 6.4e-5 at the train step's T=75; 2e-3 still fails a wrong posterior.
CTC_WITNESS_TOL = {'loss': 1e-4, 'grad': 2e-3}
# f32 operations per state and step: two log_adds of 9 (max, compare, two
# subtracts, two exps, add, log, add) and the emission add.
CTC_OPS_PER_STATE = 19
# (label, T, B, U) of the generated cases; the train step's comes from the
# loader.  S = 2U+1: 161 an eval batch's, 17 at one frame, 257 the first
# row past the warp path (S_WARP = 256), 513 a block of 17 warps, 8193
# more states than a block has threads (1024), in shared memory only with
# the opt-in, 24577 a state that does not fit beside the ring (global
# scratch).
CTC_CASES = (('eval', 200, 16, 80), ('T=1', 1, 6, 8), ('S=257', 260, 8, 128),
             ('S=513', 320, 8, 256), ('S=8193', 40, 4, 4096),
             ('S=24577', 24, 4, 12288))
# the cases timed against their plain versions and F.ctc_loss too
CTC_TIMED = ('train step', 'eval')
EVAL_BEAM = 12
BEAM_MARGIN = 1e-4


def ctc_case(labels, label_len, logit_len, T, seed, device):
    """Seeded logits ``[B, T, 49]`` and the loss's operands on ``device``,
    with the rows every case covers: 0 has no labels, 1 repeated labels
    (the skip off), 2 is impossible (more labels than frames), 3 has padded
    frames."""
    labels, label_len, logit_len = (np.array(a, dtype=np.int64) for a in
                                    (labels, label_len, logit_len))
    U = labels.shape[1]
    labels[0], label_len[0] = 0, 0
    n = min(6, U)
    labels[1, :n] = [5, 5, 9, 9, 9, 2][:n]
    label_len[1] = max(label_len[1], n)
    logit_len[1] = max(logit_len[1], min(T, 4 * n))
    n = min(4, U)
    labels[2, :n] = [3, 7, 11, 13][:n]
    label_len[2], logit_len[2] = n, min(2, T)
    logit_len[3] = max(1, T // 2)
    label_len[3] = min(label_len[3], T // 8)
    labels[np.arange(U)[None, :] >= label_len[:, None]] = 0
    g = torch.Generator().manual_seed(seed)
    logits = 2 * torch.randn((len(labels), T, VOCAB), generator=g)
    return [torch.as_tensor(a).to(device)
            for a in (logits, logit_len, labels, label_len)]


def ctc_cases(device):
    """{label: (logits, logit_len, labels, label_len)} of phase 12."""
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    batch = next(iter(loaders[1].full))
    frames = loaders[1].full.bucket_frames[0]
    T = frames // 4                      # the flagship's strides 1, 1, 2, 2
    lsize = logits_length(torch.as_tensor(batch['feature_size']), frames, T)
    cases = {'train step': ctc_case(batch['labels'], batch['label_size'],
                                    lsize, T, SEED + 12, device)}
    for label, Tc, Bc, U in CTC_CASES:
        rng = np.random.RandomState(SEED + Tc)
        labels = rng.randint(1, VOCAB, size=(Bc, U))
        most = min(U, max(1, Tc // 2))
        label_len = rng.randint(max(1, most // 2), most + 1, size=Bc)
        logit_len = rng.randint(Tc - Tc // 4, Tc + 1, size=Bc)
        cases[label] = ctc_case(labels, label_len, logit_len, Tc, SEED + U,
                                device)
    return cases


def ctc_operands(logits, logit_len, labels, label_len):
    """(em, skip_ok, final_states) as the loss builds them."""
    lp = torch.log_softmax(logits, dim=-1)
    ext = ctc._extended_labels(labels, 0)
    em = ctc._emission_logprobs(lp, ext, logit_len, 0)
    return em, ctc._transition_masks(ext, 0), ctc._final_states(
        label_len, ext.shape[1])


def ctc_kernel_calls(em, skip, final):
    """{'alpha' | 'beta': a call of the kernel's wrapper on the operands}."""
    return {'alpha': lambda: ctc_pallas._launch_alpha(em, skip),
            'beta': lambda: ctc_pallas._launch_beta(em, skip, final)}


def stack_errors(got, want):
    """(max abs error of the finite entries, floored entries); asserts the
    JAX tolerance and the same floor pattern."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    floored = want <= CTC_FLOOR
    assert torch.equal(got <= CTC_FLOOR, floored), 'floor patterns differ'
    err = (got - want).abs()[~floored]
    bad = err > CTC_ATOL + CTC_RTOL * want.abs()[~floored]
    assert not bool(bad.any()), float(err.max())
    return (float(err.max()) if err.numel() else 0.0), int(floored.sum())


def loss_and_grad(logits, logit_len, labels, label_len, fn):
    """Per-row losses and the logits gradient of their sum over the rows
    that have an alignment."""
    lg = logits.detach().clone().requires_grad_()
    loss = fn(lg, logit_len, labels, label_len)
    (g,) = torch.autograd.grad(
        torch.where(torch.isfinite(loss), loss, 0.0).sum(), lg)
    return loss.detach(), g


def f_ctc(logits, logit_len, labels, label_len):
    """F.ctc_loss on the same rows (zero_infinity: the impossible row 0)."""
    return torch.nn.functional.ctc_loss(
        torch.log_softmax(logits, -1).transpose(0, 1), labels, logit_len,
        label_len, reduction='none', zero_infinity=True)


def ctc_bound(T, B, S, name):
    """(ms, 'bytes' | 'operations'): em read and the stack written once,
    with the [B, S] bool masks (one for alpha, two for beta), against
    CTC_OPS_PER_STATE f32 operations per state and step."""
    nbytes = 4 * 2 * T * B * S + (1 if name == 'alpha' else 2) * B * S
    t_bytes = nbytes / MEM_BYTES_S
    t_ops = CTC_OPS_PER_STATE * T * B * S / PEAK_OPS_S[torch.float32]
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def ctc_library_times(case, em, skip, final):
    """Plain version and library times of both recursions on one case; the
    library is F.ctc_loss on the same rows, its forward for alpha and its
    backward (autograd, the loss kept) for beta, on log-probabilities it is
    given."""
    logits, logit_len, labels, label_len = case
    lp = torch.log_softmax(logits, -1).transpose(0, 1).detach()
    lpg = lp.clone().requires_grad_()
    args = (labels, logit_len, label_len)
    f_loss = torch.nn.functional.ctc_loss(lpg, *args, reduction='none',
                                          zero_infinity=True)
    ones = torch.ones_like(f_loss)
    calls = {
        'alpha': (lambda: ctc_pallas.alpha_scan_reference(em, skip),
                  lambda: torch.nn.functional.ctc_loss(
                      lp, *args, reduction='none', zero_infinity=True)),
        'beta': (lambda: ctc_pallas.beta_scan_reference(em, skip, final),
                 lambda: torch.autograd.grad(f_loss, lpg, ones,
                                             retain_graph=True))}
    rows = {}
    for name, (plain, library) in calls.items():
        with torch.enable_grad():
            library_ms = time_ms(library)
        with torch.no_grad():
            rows[name] = dict(plain_ms=time_ms(plain, runs=10),
                              library_ms=library_ms)
    return rows


def check_ctc_kernels(device):
    """Phase 12.  Returns ({'alpha'|'beta': max abs error}, {case: {name:
    timing row}}, loss readings)."""
    cases = ctc_cases(device)
    errors = {'alpha': 0.0, 'beta': 0.0}
    readings, times = {}, {}
    for label, case in cases.items():
        with torch.no_grad():
            em, skip, final = ctc_operands(*case)
            T, B, S = em.shape
            calls = ctc_kernel_calls(em, skip, final)
            want = {'alpha': ctc_pallas.alpha_scan_reference(em, skip),
                    'beta': ctc_pallas.beta_scan_reference(em, skip, final)}
            plan = ctc_pallas.device_plan(em)
            times[label] = {}
            for name, call in calls.items():
                got, again = call(), call()
                torch.cuda.synchronize()
                assert torch.equal(got, again), ('two calls differ', name, label)
                err, floored = stack_errors(got, want[name])
                errors[name] = max(errors[name], err)
                bound_ms, bound_by = ctc_bound(T, B, S, name)
                row = dict(T=T, B=B, S=S, path=plan['path'], warps=plan['warps'],
                           ring=plan['ring'], state=plan['state'],
                           ms=time_ms(call), device_ms=device_ms(call),
                           bound_ms=bound_ms, bound_by=bound_by)
                row['us_per_step'] = 1e3 * row['device_ms'] / T
                times[label][name] = row
                print(f'ctc {name:5s} kernel vs plain  {label:10s} T={T:3d} '
                      f'B={B:2d} S={S:5d}: max_abs_err {err:.3e} over the '
                      f'finite entries, {floored} floored on both sides, two '
                      f'calls bit-equal; path {plan["path"]} ({plan["warps"]} '
                      f'warps, ring {plan["ring"]}, state {plan["state"]}): events '
                      f'{row["ms"]:.4f} ms, device {row["device_ms"]:.4f} ms, '
                      f'{row["us_per_step"]:.3f} us per step; bound '
                      f'{bound_ms:.5f} ms ({bound_by})')
        got, got_g = loss_and_grad(*case, ctc.ctc_loss)
        with plain_ctc():
            want, want_g = loss_and_grad(*case, ctc.ctc_loss)
        wit, wit_g = loss_and_grad(*case, f_ctc)
        ok = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), ok) and not bool(ok[2])
        assert bool(torch.isfinite(got_g).all()) and not bool(got_g[2].any())
        loss_err = float(((got - want).abs() / want.abs().clamp(min=1e-30))[ok].max())
        grad_err = float((got_g - want_g).abs().max() / want_g.abs().max())
        labelled = ok & (case[3] > 0)
        assert bool(labelled.any()), label
        wit_loss = float(((got - wit).abs() / wit.abs().clamp(min=1e-30))[ok].max())
        wit_grad = float((got_g - wit_g)[labelled].abs().max()
                         / wit_g[labelled].abs().max())
        print(f'ctc loss {label:10s}: kernels vs plain on the card: loss '
              f'{loss_err:.2e} relative, logits gradient {grad_err:.2e} of the '
              f'scale (tol {CTC_LOSS_TOL:.0e}); F.ctc_loss witness: loss '
              f'{wit_loss:.2e} (tol {CTC_WITNESS_TOL["loss"]:.0e}), gradient '
              f'on the labelled rows {wit_grad:.2e} (tol '
              f'{CTC_WITNESS_TOL["grad"]:.0e})')
        assert loss_err <= CTC_LOSS_TOL and grad_err <= CTC_LOSS_TOL, label
        assert wit_loss <= CTC_WITNESS_TOL['loss'], label
        assert wit_grad <= CTC_WITNESS_TOL['grad'], label
        readings[label] = dict(loss=loss_err, grad=grad_err,
                               witness_loss=wit_loss, witness_grad=wit_grad)
        if label in CTC_TIMED:
            for name, r in ctc_library_times(case, em, skip, final).items():
                times[label][name].update(r)
                r = times[label][name]
                print(f'ctc {name:5s} {label:10s} T={T} B={B} S={S}: kernel '
                      f'{r["ms"]:.4f} ms (device {r["device_ms"]:.4f}), plain '
                      f'{r["plain_ms"]:.4f}, F.ctc_loss '
                      f'{"forward" if name == "alpha" else "backward"} '
                      f'{r["library_ms"]:.4f}')
    for label in CTC_TIMED:
        assert all(r['path'] == 'warp' for r in times[label].values()), label
    logits, logit_len, labels, label_len = cases['train step']
    lg = logits.clone().requires_grad_()
    port_ms = time_ms(lambda: torch.autograd.grad(
        ctc.normalized_ctc_loss(lg, logit_len, labels, label_len).sum(), lg))
    lib_ms = time_ms(lambda: torch.autograd.grad(
        f_ctc(lg, logit_len, labels, label_len).sum(), lg))
    print(f'ctc layer, train step shapes: the port\'s normalized_ctc_loss '
          f'forward + backward {port_ms:.4f} ms; F.ctc_loss on log_softmax '
          f'{lib_ms:.4f} ms')
    readings['layer_ms'] = dict(port=port_ms, f_ctc_loss=lib_ms)
    return errors, times, readings


def check_eval(device):
    """Phase 13.  Returns the eval pass's launches and readings."""
    model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                      generator=torch.Generator().manual_seed(SEED + 13))
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    val = list(loaders[2])
    trainer = Trainer(loaders, device=device, verbose=False)
    assert trainer.eval_decoder == 'beam' and trainer.beam_width == EVAL_BEAM
    trainer.init_state(model, seed=SEED)
    trainer.evaluate(val)                                      # warm-up
    torch.cuda.synchronize()
    ctc_pallas.reset_launches()
    t0 = time.perf_counter()
    m = trainer.evaluate(val)
    wall = time.perf_counter() - t0
    launches = {k: dict(v) for k, v in ctc_pallas.LAUNCHES.items()}
    print(f'eval [beam W={EVAL_BEAM}]: {len(val)} batch(es) of {TRAIN_B}, '
          f'{wall * 1e3 / len(val):.3f} ms per batch (host clock); {m}; '
          f'CTC launches {launches}')
    assert launches == {'alpha': {'kernel': len(val), 'plain': 0},
                        'beta': {'kernel': 0, 'plain': 0}}, launches
    assert all(np.isfinite(v) for v in m.values()), m

    batch = trainer._put_batch(val[0])
    with torch.no_grad():
        logits, lsize = trainer._eval_logits(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, n, _ = decode._beam_search(logits, lsize, EVAL_BEAM, None, 0)
    torch.cuda.synchronize()
    beam_ms = 1e3 * (time.perf_counter() - t0)
    want, want_n, scores = decode._beam_search(logits.cpu(), lsize.cpu(),
                                               EVAL_BEAM, None, 0)
    top2 = scores.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > BEAM_MARGIN) & (batch['valid'].cpu() > 0)
    ids, n = ids.cpu(), n.cpu()
    same = (ids == want).all(1) & (n == want_n)
    print(f'eval beam search, card vs cpu on the card\'s f32 logits '
          f'{tuple(logits.shape)}: ids equal on {int(same[clear].sum())}/'
          f'{int(clear.sum())} valid rows whose best two beams differ by more '
          f'than {BEAM_MARGIN:g} (equal on {int(same.sum())}/{len(same)} rows '
          f'in all); {beam_ms:.3f} ms on the card (host clock)')
    assert bool(same[clear].all()) and int(clear.sum()) > 0
    return launches['alpha']['kernel'], dict(
        eval_ms_per_batch=wall * 1e3 / len(val), beam_ms=beam_ms,
        beam_rows_compared=int(clear.sum()), metrics=m)


def ctc_entry(name, errors, times, readings, train, eval_alpha):
    """The kernels line's entry for one CTC recursion: times at the train
    step's shapes, launches over the train steps of phases 7 and 11 and the
    eval pass of phase 13."""
    per_path = {impl: launches[f'ctc_{name}']
                for impl, (launches, _) in train.items()}
    if name == 'alpha':
        per_path['eval'] = eval_alpha
    row = times['train step'][name]
    return dict(
        name=f'ctc_{name}', route='cuda', source=CTC_SOURCE,
        replaces=CTC_REPLACES[name], launches=sum(per_path.values()),
        launches_per_path=per_path, launches_per_train_step=1,
        launches_per_eval_batch=1 if name == 'alpha' else 0,
        max_abs_err=errors[name], ms=row['ms'], plain_ms=row['plain_ms'],
        bound_ms=row['bound_ms'], bound_by=row['bound_by'],
        library_ms=row['library_ms'], device_ms=row['device_ms'],
        us_per_step=row['us_per_step'], path=row['path'],
        times_cover=f'one call at the train step\'s shapes, T={row["T"]}, '
                    f'B={row["B"]}, S={row["S"]}: ms on CUDA events, '
                    'device_ms per call of 20 queued behind a spin kernel, '
                    'us_per_step device_ms / T; library_ms '
                    'F.ctc_loss\'s '
                    + ('forward' if name == 'alpha' else 'backward')
                    + ' on the same rows',
        checked_at='train step T=75 B=32 S=65, eval T=200 B=16 S=161, '
                   'T=1 B=6 S=17 (warp path); T=260 B=8 S=257, T=320 B=8 '
                   'S=513, T=40 B=4 S=8193, T=24 B=4 S=24577 (block path, '
                   'the last with the state in global memory); rows with no '
                   'labels, repeats, padded frames, an impossible alignment; '
                   'two calls bit-equal at each',
        eval_shape=times['eval'][name],
        per_case={label: t[name] for label, t in times.items()},
        loss_readings=readings)


def gconv_step_sums(rows, name, layout, keys):
    """{key: the sum over one flagship train step's 54 bf16 conv5 nodes}
    of kernel ``name``'s timing rows in ``layout`` (3 nodes per cell)."""
    per = [r for r in rows if r['kernel'] == name and r['layout'] == layout
           and r['dtype'] == 'bfloat16']
    return {k: sum(3 * n * r[k] for n, r in zip(CELLS_PER_BLOCK, per))
            for k in keys}


def gconv_entry(name, errors, rows, train, logits, grads, nonfinite):
    """The kernels line's entry for one grouped conv kernel: times summed
    over the 54 bf16 conv5 nodes of one flagship train step, the 'pallas'
    layout (dense) as ms and the 'pallas_split' layout as split_*."""
    def step(layout, key):
        return gconv_step_sums(rows, name, layout, (key,))[key]

    f32, bf16 = errors[name][torch.float32], errors[name][torch.bfloat16]
    per_path = {impl: launches[f'grouped_{name}']
                for impl, (launches, _) in train.items()}
    entry = dict(
        name=f'grouped_conv_{name}', route='cuda', source=GCONV_SOURCE,
        replaces=GCONV_REPLACES[name], launches=sum(per_path.values()),
        launches_per_path=per_path, launches_per_train_step=54,
        max_abs_err=f32[0], max_share_err=f32[1], max_abs_err_bf16=bf16[0],
        max_share_err_bf16=bf16[1],
        ms=step('dense', 'ms'), plain_ms=step('dense', 'plain_ms'),
        bound_ms=step('dense', 'bound_ms'),
        bound_by='bytes' if all(r['bound_by'] == 'bytes' for r in rows
                                if r['kernel'] == name) else 'operations',
        library_ms=step('dense', 'library_ms'),
        split_ms=step('split', 'ms'), split_plain_ms=step('split', 'plain_ms'),
        split_bound_ms=step('split', 'bound_ms'),
        split_library_ms=step('split', 'library_ms'),
        times_cover='the 54 bf16 conv5 nodes of one flagship train step, '
                    'B=32, T=300/300/150/75; ms, plain_ms, bound_ms in the '
                    "'pallas' layout (dense [B, T, C]), split_* in the "
                    "'pallas_split' layout; library_ms one cuDNN call per "
                    'node on inputs in its own layout',
        checked_at={'forward': GCONV_FWD_CHECKED_AT, 'dx': GCONV_DX_CHECKED_AT,
                    'dw': GCONV_DW_CHECKED_AT}[name],
        per_width=[r for r in rows if r['kernel'] == name],
        device_ms=step('dense', 'device_ms'),
        library_device_ms=step('dense', 'library_device_ms'),
        split_device_ms=step('split', 'device_ms'),
        split_library_device_ms=step('split', 'library_device_ms'),
        device_times_cover='the same nodes, device time per call of 20 '
                           'calls queued back to back behind a spin '
                           "kernel (no wrapper host time), the kernel's "
                           "and cuDNN's alike")
    if name == 'forward':
        entry['launches_per_model_forward'] = {
            impl: n for impl, (_, n) in logits.items()}
        entry['logits_vs_fused_share'] = {
            impl: share for impl, (share, _) in logits.items()}
    else:
        entry['step_gradient_worst_share'] = grads
    if name in nonfinite:
        entry['nonfinite_outputs_checked'] = nonfinite[name]
    return entry


# ---------------------------------------------------------------------------
# phase 14: the NAS path (dataset queries, zero-cost proxies, proxy search)
# ---------------------------------------------------------------------------

GOLDEN_HASH = '36855332a5778e0df5114305bc3ce238'
DB = pathlib.Path(__file__).resolve().parent / 'db'     # committed folders
# together they hold all six ops: conv5 (flagship), linear + conv5d2 +
# conv7d2, conv7 + zero + linear, and zero alone (cells with no live node)
NAS_ARCHS = {
    'flagship': FLAGSHIP,
    'linear+dilated': SPECS['linear+dilated']['arch'],
    'conv7+zero+linear': SPECS['conv7+zero+linear']['arch'],
    'all-zero': [[5, 0], [5, 0, 0], [5, 0, 0, 0]],
}
NAS_PROXIES = ('grad_norm', 'snip', 'synflow')
NAS_FRAMES = 128            # the CLI's batch: B=1, T=128, 8 labels
NAS_SEARCH_CANDIDATES = 8
NAS_SEARCH_PROXIES = ('synflow', 'grad_norm')
# Kernels against the plain versions on the card, in two ways.
# Call by call: inside the kernels' pass every fused cell's forward and
# backward is also run as its plain version on the same inputs (the
# backward on the kernel's own saved node outputs and multipliers, so no
# gate differs), at the proxies' shapes (B=1, T=128 to 32), and each
# output is held as phase 6 holds them: the forward's output and node
# outputs to TOL, every backward output (dx, each dW and db, the LayerNorm
# gradients) to GRAD_TOL of its own max, and the gates that flip over the
# pass to GATE_FLIP_SHARE.  Pass against pass: the model's output to
# NAS_OUT_TOL of its largest value (readings 5e-6 to 1.3e-5), the score to
# NAS_GRAD_FACTOR times the witness's share of it, or NAS_SCORE_TOL where
# that is more, and every gradient tensor, as a share of its plain max, to
# NAS_GRAD_CAP.  The witness is the plain versions with every cell's
# parameters and output, and the gradient reaching it, multiplied by 1 +-
# 2^-23 (one ulp, signs drawn from a seed; NAS_WITNESS_SEEDS draws).  A
# pass's gradient tensor cannot be held tighter: at random init, B=1, f32
# rounding that reaches a clip gate moves a tensor by up to a tenth or so
# (readings 12.4% on the flagship, 8.5% on conv7+zero+linear, the witness
# as far on those tensors), and which gate it reaches is a draw, so a
# per-tensor bound of 2x the witness failed the honest kernels 14x over on
# tensors the witness's draws left alone.  The cap, 0.5, is half of what
# the faults this check is for give: a gradient zeroed reads 1, negated 2.
# The phase plants two faults in the kernels' backward (the last cell's
# first bias gradient negated, and its input gradient) and asserts that
# both checks reject each.
NAS_OUT_TOL = 1e-4
NAS_GRAD_FACTOR = 2.0
NAS_GRAD_CAP = 0.5
NAS_SCORE_TOL = 1e-4
NAS_WITNESS_SEEDS = 3
# fused forward and backward launches per proxy call (one per cell), and
# CTC alpha / beta launches (the loss proxies only)
NAS_CELL_LAUNCHES = sum(CELLS_PER_BLOCK)


def nas_batch(frames, device):
    """The CLI's seeded batch (``nbasr_torch/cli.py``), on ``device``."""
    rng = np.random.RandomState(0)
    feats = rng.randn(1, frames, 80).astype('float32')
    labels = rng.randint(1, 49, size=(1, 8)).astype('int32')
    return [torch.as_tensor(a).to(device) for a in (
        feats, np.asarray([frames], 'int32'), labels,
        np.asarray([8], 'int32'))]


@contextlib.contextmanager
def timed_plans():
    """Inside, the fused cell's plan functions add their seconds and calls
    to the yielded dict (a new cell shape is planned once, then cached)."""
    saved = fused_cell.forward_plans, fused_cell.backward_plans
    spent = {'s': 0.0, 'plans': 0}

    def timed(fn):
        def plan(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent['s'] += time.perf_counter() - t
                spent['plans'] += 1
        return plan

    fused_cell.forward_plans, fused_cell.backward_plans = map(timed, saved)
    try:
        yield spent
    finally:
        fused_cell.forward_plans, fused_cell.backward_plans = saved


@contextlib.contextmanager
def nudged_cells(model, seed):
    """A witness only: inside, every SearchCell's parameters and output,
    and the gradient that reaches its output, are multiplied by 1 +-
    2^-23, one ulp up or down, signs drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def factor(t):
        sign = torch.randint(0, 2, t.shape, generator=g) * 2 - 1
        return 1 + 2.0 ** -23 * sign.to(t.device, t.dtype)

    def nudge(module, args, out):
        out = out * factor(out)
        if out.requires_grad:
            out.register_hook(lambda dy: dy * factor(dy))
        return out

    cells = [m for m in model.modules() if isinstance(m, SearchCell)]
    params = [p for m in cells for p in m.parameters()]
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.mul_(factor(p))
    hooks = [m.register_forward_hook(nudge) for m in cells]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)


def nas_launches():
    return (dict(fused_cell.LAUNCHES), dict(fused_cell.BACKWARD_LAUNCHES),
            {k: dict(v) for k, v in ctc_pallas.LAUNCHES.items()})


def reset_nas_launches():
    fused_cell.reset_launches()
    ctc_pallas.reset_launches()


def expected_nas_launches(name, calls=1):
    cells = {'kernel': calls * NAS_CELL_LAUNCHES, 'plain': 0}
    ctc_calls = 0 if name == 'synflow' else calls
    return (cells, dict(cells), {k: {'kernel': ctc_calls, 'plain': 0}
                                 for k in ('alpha', 'beta')})


def add_launches(total, got):
    """Add ``nas_launches()``'s counts to ``total``: a Counter each for the
    fused forward and backward and the CTC alpha and beta."""
    fwd, bwd, ctc_counts = got
    for acc, part in zip(total, (fwd, bwd, ctc_counts['alpha'],
                                 ctc_counts['beta'])):
        acc.update(part)


def share(a, b):
    """|a - b| as a share of |b| (0 where both are 0)."""
    return abs(a - b) / abs(b) if b else abs(a - b)


def check_nas_queries():
    """Phase 14's host part: the committed dataset folders, no JAX."""
    d = nbasr_torch.from_folder(DB, max_epochs=2)
    info = d.full_info(FLAGSHIP, seed=d.seeds[0])
    assert search_space.get_model_hash(FLAGSHIP) == GOLDEN_HASH
    assert info['model_hash'] == GOLDEN_HASH, info
    e40 = nbasr_torch.from_folder(DB / 'e40')
    arch = next(iter(e40.dbs[0].values()))[-1]
    per = [(e40.val_acc(arch, seed=s), e40.test_acc(arch, seed=s))
           for s in e40.seeds]
    assert all(np.isfinite(v) for v in [info['test_per'], *info['val_per'],
                                        *np.ravel(per)]), (info, per)
    print(f'nas queries: flagship {info["model_hash"]} in db/ (e2, seed '
          f'{info["seed"]}): val PER {info["val_per"]}, test PER '
          f'{info["test_per"]}; db/e40 ({len(e40.dbs[0])} archs x seeds '
          f'{e40.seeds}) {arch}: (best val, test) PER {per}')


def nas_pass(name, model, batch):
    """(the model's output, {parameter: gradient}, the score) of one proxy
    pass on ``model`` in eval mode, through ``proxies``' own objective and
    gradients; the output from a forward of its own."""
    feats, fsize = batch[:2]
    if name == 'synflow':
        objective = proxies._synflow_objective(model, feats, fsize)
        feats = torch.ones_like(feats)
    else:
        objective = proxies._loss(model, *batch)
    pairs = proxies._grads(model, objective)
    out = model(feats, fsize).detach()
    score = (proxies._norm(pairs) if name == 'grad_norm'
             else proxies._sensitivity(pairs))
    names = [n for n, _ in model.named_parameters()]
    return out, {n: g for n, (_, g) in zip(names, pairs) if g is not None}, \
        score


def grad_shares(got, ref):
    """{tensor: max |got - ref| as a share of max |ref|}."""
    assert got.keys() == ref.keys(), got.keys() ^ ref.keys()
    return {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
            for n, w in ref.items()}


def worse(a, b):
    """The larger of two shares, a NaN counted as infinite."""
    return max(a, b if b == b else float('inf'))


@contextlib.contextmanager
def checked_cells():
    """A witness only, never the main path: inside, every fused cell call
    on the card also runs its plain version on the same inputs (the
    backward on the kernel's saved node outputs and multipliers); the
    yielded dict keeps the worst forward and backward shares of the scale,
    the gate flips among the gates compared, and the backward calls."""
    fwd, bwd = fused_cell.fused_cell_train_forward, \
        fused_cell.fused_cell_backward
    stats = dict(fwd=0.0, bwd=0.0, flips=0, gates=0, calls=0)

    def forward(spec, x, weights, ln, seed=None):
        got = fwd(spec, x, weights, ln, seed)
        want = fused_cell.fused_cell_reference(spec, x, weights, ln, seed,
                                               save=True)
        for a, b in zip(got[:2], want[:2]):
            err = float((a.float() - b.float()).abs().max())
            stats['fwd'] = worse(stats['fwd'], err / max(
                float(b.float().abs().max()), 1e-30))
        live = [i for i, n in enumerate(spec.nodes) if n.kind != 'zero']
        stats['flips'] += int((got[2][live] != want[2][live]).sum())
        stats['gates'] += got[2][live].numel()
        return got

    def backward(*args):
        got = bwd(*args)
        stats['bwd'] = worse(stats['bwd'], grad_errors(
            got, fused_cell.fused_cell_backward_reference(*args))[1])
        stats['calls'] += 1
        return got

    fused_cell.fused_cell_train_forward = forward
    fused_cell.fused_cell_backward = backward
    try:
        yield stats
    finally:
        fused_cell.fused_cell_train_forward = fwd
        fused_cell.fused_cell_backward = bwd


def cells_ok(stats, tol=GRAD_TOL[torch.float32]):
    """Whether one pass's calls, as ``checked_cells`` saw them, are within
    the call-by-call bounds (the backward's to ``tol``)."""
    return (stats['calls'] == NAS_CELL_LAUNCHES
            and stats['fwd'] <= TOL[torch.float32] and stats['bwd'] <= tol
            and stats['flips'] <= GATE_FLIP_SHARE * stats['gates'])


def check_nas_proxy(name, arch_name, batch, device, card):
    """One proxy on one arch at full width: the main path through
    ``compute_proxy`` (launches counted), then the same model's pass with
    the kernels, each cell call held against its plain version, and its
    score, output and every gradient against the plain versions' pass and
    the witness; two planted faults; times."""
    arch = NAS_ARCHS[arch_name]
    kw = {'use_norm': False} if name == 'synflow' else {}
    reset_nas_launches()
    with timed_plans() as plans:
        t0 = time.perf_counter()
        score = proxies.compute_proxy(name, arch, *batch, seed=SEED,
                                      device=device)
        first_s = time.perf_counter() - t0
    launches = nas_launches()
    assert launches == expected_nas_launches(name), (name, arch, launches)
    t0 = time.perf_counter()
    model = proxies._build_model(arch, SEED, device, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model.eval()
    score_fn = getattr(proxies, f'_score_{name}')

    def run():
        return score_fn(model, *batch)

    with checked_cells() as cells:
        out, grads, kernel = nas_pass(name, model, batch)
    ms = time_ms(run, runs=5, warmup=1)
    faulty = {}
    for fault in ('bias', 'dx'):
        with planted_fault(fault), checked_cells() as stats:
            faulty[fault] = (nas_pass(name, model, batch)[1], stats)
        assert stats['calls'] == NAS_CELL_LAUNCHES, stats
    with plain_cells(), plain_ctc():
        plain_out, plain_grads, plain = nas_pass(name, model, batch)
        plain_ms = time_ms(run, runs=3, warmup=0)
        witness, witness_score = {}, 0.0
        for k in range(NAS_WITNESS_SEEDS):
            with nudged_cells(model, SEED + 14 + k):
                _, nudged, nudged_score = nas_pass(name, model, batch)
            for n, v in grad_shares(nudged, plain_grads).items():
                witness[n] = worse(witness.get(n, 0.0), v)
            witness_score = worse(witness_score, share(nudged_score, plain))
    shares = grad_shares(grads, plain_grads)
    worst = max(shares, key=shares.get)
    planted = {}
    for fault, (g, stats) in faulty.items():
        s = grad_shares(g, plain_grads)
        at = max(s, key=s.get)
        planted[fault] = dict(cells_bwd=stats['bwd'], tensor=at,
                              share=s[at], rejected=not cells_ok(stats)
                              and s[at] > NAS_GRAD_CAP)
    scale = float(plain_out.abs().max())
    out_share = float((out - plain_out).abs().max()) / (scale or 1.0)
    row = dict(proxy=name, arch=arch_name, score=score, kernel=kernel,
               plain=plain, share=share(kernel, plain),
               score_bound=max(NAS_SCORE_TOL,
                               NAS_GRAD_FACTOR * witness_score),
               witness_share=witness_score, out_share=out_share,
               cells=cells, cells_ok=cells_ok(cells), tensors=len(shares),
               grad_worst=[worst, shares[worst], witness[worst]],
               grad_witness=max(witness.values()), planted=planted,
               first_call_s=first_s, plan_s=plans['s'], plans=plans['plans'],
               build_s=build_s, ms=ms, plain_ms=plain_ms)
    print(f'  {name:9s} {arch_name:18s} {kernel:.7g} (entry point '
          f'{score:.7g}), plain {plain:.7g}: share {row["share"]:.2e} '
          f'(bound {row["score_bound"]:.2e}), output {out_share:.2e}; '
          f'{cells["calls"]} cell calls against plain: forward '
          f'{cells["fwd"]:.2e}, backward {cells["bwd"]:.2e}, gate flips '
          f'{cells["flips"]}/{cells["gates"]}; {len(shares)} gradients, worst '
          f'{worst} {shares[worst]:.2e} (witness {witness[worst]:.2e}, '
          f'largest {row["grad_witness"]:.2e}); planted faults: ' + ', '.join(
              f'{f} cells {p["cells_bwd"]:.2f}, {p["tensor"]} {p["share"]:.2f}'
              for f, p in planted.items())
          + f'; {ms:.3f} ms a call (plain {plain_ms:.3f}), first call '
          f'{first_s:.3f} s of which planning {plans["s"]:.3f} s '
          f'({plans["plans"]} plans), model build {build_s:.3f} s [{card}]')
    assert all(np.isfinite(v) for v in (score, kernel, plain)), row
    return row, launches


def nas_row_faults(row):
    """What is wrong with one proxy row, if anything."""
    faults = []
    if not row['share'] <= row['score_bound']:
        faults.append('score')
    if not row['out_share'] <= NAS_OUT_TOL:
        faults.append('output')
    if not row['cells_ok']:
        faults.append('cell calls')
    if not row['grad_worst'][1] <= NAS_GRAD_CAP:
        faults.append('gradients')
    if row['proxy'] == 'synflow' and not (
            row['score'] == row['kernel'] == row['plain'] == 0.0):
        faults.append('synflow is not 0')
    if row['arch'] != 'all-zero':   # no weight, and no gradient reaches x
        faults += [f'planted {f} passed' for f, p in row['planted'].items()
                   if not p['rejected']]
    return faults


def check_nas_search(name, device, card):
    """``proxy_search`` on the card (launches counted), then the same
    search with the plain versions as a witness: the same top 5."""
    reset_nas_launches()
    with timed_plans() as plans:
        t0 = time.perf_counter()
        top = search.proxy_search(name, num_candidates=NAS_SEARCH_CANDIDATES,
                                  seed=SEED, device=device)
        wall = time.perf_counter() - t0
    launches = nas_launches()
    assert launches == expected_nas_launches(name, NAS_SEARCH_CANDIDATES), \
        launches
    with plain_cells(), plain_ctc():
        plain = search.proxy_search(name, num_candidates=NAS_SEARCH_CANDIDATES,
                                    seed=SEED, device=device)
    print(f'proxy_search({name}, {NAS_SEARCH_CANDIDATES} candidates, seed '
          f'{SEED}, T=64): {wall:.3f} s wall, planning {plans["s"]:.3f} s '
          f'({plans["plans"]} plans); top 5: {top}; plain versions: '
          f'{[s for _, s in plain]} [{card}]')
    assert len(top) == min(5, NAS_SEARCH_CANDIDATES), top
    assert all(np.isfinite(s) for _, s in top), top
    assert [a for a, _ in top] == [a for a, _ in plain], (top, plain)
    if name == 'synflow':       # block 1 saturates, as in the phase above
        assert all(s == 0.0 for _, s in top + plain), (top, plain)
    else:                       # a real ranking: distinct scores
        scores = [s for _, s in top]
        assert all(a > b > 0 for a, b in zip(scores, scores[1:])), top
    return dict(wall_s=wall, plan_s=plans['s'], top=top), launches


def check_nas(device):
    """Phase 14.  Returns the rows and the launches of the main path."""
    card = card_line()
    check_nas_queries()
    batch = nas_batch(NAS_FRAMES, device)
    total = [collections.Counter() for _ in range(4)]
    rows = []
    print(f'nas proxies at full width, f32, B=1, T={NAS_FRAMES} (the CLI '
          f'batch): score with the kernels, plain versions on the card')
    for arch_name in NAS_ARCHS:
        for name in NAS_PROXIES:
            row, launches = check_nas_proxy(name, arch_name, batch, device,
                                            card)
            rows.append(row)
            add_launches(total, launches)
    by = {(r['proxy'], r['arch']): r for r in rows}
    over = {k: f for k, r in by.items() if (f := nas_row_faults(r))}
    assert not over, over

    searches = {}
    for name in NAS_SEARCH_PROXIES:
        searches[name], launches = check_nas_search(name, device, card)
        add_launches(total, launches)

    cli_scores = {}
    for name in NAS_SEARCH_PROXIES:
        reset_nas_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(['proxy', name, *map(str, flatten(FLAGSHIP)),
                      '--device', device.type])
        cli_scores[name] = float(out.getvalue())
        launches = nas_launches()
        assert launches == expected_nas_launches(name), launches
        add_launches(total, launches)
        row = by[name, 'flagship']
        assert share(cli_scores[name], row['score']) <= row['score_bound'], \
            (name, cli_scores[name], row['score'])
        print(f'python -m nbasr_torch.cli proxy {name} {FLAGSHIP}: '
              f'{cli_scores[name]}')
    assert cli_scores['synflow'] == 0.0, cli_scores
    return rows, total, dict(searches=searches, cli=cli_scores)


# ---------------------------------------------------------------------------
# phase 15: a JAX-format checkpoint round trip, the resumed step, the CLI's
# quantize, int8 serving and remat_cells
# ---------------------------------------------------------------------------

# int8 stream against the f32 stream of the same weights, as relative L2
# error of the logits.  On the CPU at full width (four seeded 8 s streams,
# chunk_frames=240) the random-init flagship read 0.301 with the seed-0
# init this phase starts from and 0.144 with seed 1 (a CPU rehearsal of
# this phase, its 2 steps at B=4, read 0.245): per-channel int8 moves
# each weight by up to half a step, and the random-weight flagship carries
# that ~1.2x a cell.  Twice the seed-0 reading catches a broken int8 path
# (a wrong scale axis or layout lands near 1 and above), not that drift.
INT8_SERVE_CPU_READING = 0.301
INT8_SERVE_TOL = 2 * INT8_SERVE_CPU_READING
# bytes of a flagship checkpoint's three f32 copies (params, mu, nu), for
# the size check (msgpack headers add ~0.1%)
CKPT_BYTES = 3 * 4 * 26_339_349


def _train_model(device, seed, **kw):
    return get_model(FLAGSHIP, use_rnn=True, dropout_rate=DROPOUT,
                     data_norm=True, compute_dtype=torch.bfloat16,
                     device=device, generator=torch.Generator().manual_seed(
                         seed), **kw)


def _bit_equal_states(a, b):
    """Names where two trainers' parameters or Adam states differ by a bit."""
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    bad = [n for n in pa if not torch.equal(pa[n], pb[n])]
    for n in pa:
        sa, sb = a.optimizer.state[pa[n]], b.optimizer.state[pb[n]]
        bad += [f'{n}.{k}' for k in ('step', 'exp_avg', 'exp_avg_sq')
                if not torch.equal(sa[k].cpu(), sb[k].cpu())]
    return bad


def check_checkpoint(device, root, card):
    """Phase 15, part 1: 2 bf16 steps, ``save_flax``, ``Trainer.load`` into
    a fresh trainer, bit-equal states, then one step each with the same
    generator state: bit-equal again, 18 + 18 fused and 1 + 1 CTC launches
    in the resumed step.  Returns (the checkpoint path, readings, launches
    of the resumed step)."""
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    batches = list(loaders[1].full)
    writer = Trainer(loaders, device=device)
    writer.init_state(_train_model(device, SEED), seed=SEED)
    for i in range(2):
        writer.step(batches[i % len(batches)], lr=1e-4)
    path = root / 'latest.ckpt'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_flax(writer, path, epoch=1, best_val=1.0)
    write_s = time.perf_counter() - t0
    size = path.stat().st_size
    assert CKPT_BYTES < size < 1.01 * CKPT_BYTES, size
    reader = Trainer(loaders, device=device)
    reader.init_state(_train_model(device, SEED + 7), seed=SEED + 7)
    t0 = time.perf_counter()
    meta = reader.load(path)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    assert meta == {'epoch': 1, 'best_val': 1.0}, meta
    assert reader.step_count == writer.step_count == 2
    bad = _bit_equal_states(writer, reader)
    assert not bad, bad[:5]
    mb = size / 1e6
    print(f'checkpoint: save_flax {mb:.1f} MB in {write_s:.3f} s '
          f'({mb / write_s:.1f} MB/s), Trainer.load (flax) {read_s:.3f} s '
          f'({mb / read_s:.1f} MB/s); params, Adam step/exp_avg/exp_avg_sq '
          f'and step count bit-equal [{card}]')

    # the resumed step against the writer's next step, same masks
    reader.generator.set_state(writer.generator.get_state())
    with recipe_seeds.deterministic():
        nxt = batches[2 % len(batches)]
        writer.step(nxt, lr=1e-4)
        torch.cuda.synchronize()
        fused_cell.reset_launches()
        ctc_pallas.reset_launches()
        m = reader.step(nxt, lr=1e-4)
        torch.cuda.synchronize()
    launches = {'fused_forward': dict(fused_cell.LAUNCHES),
                'fused_backward': dict(fused_cell.BACKWARD_LAUNCHES),
                **{f'ctc_{k}': dict(v) for k, v in ctc_pallas.LAUNCHES.items()}}
    print(f'resumed step: launches {launches}, loss {m["ctc_loss"]:.4f}')
    for name, counts in launches.items():
        want = 1 if name.startswith('ctc') else 18
        assert counts == {'kernel': want, 'plain': 0}, (name, counts)
    bad = _bit_equal_states(writer, reader)
    assert not bad, bad[:5]
    assert np.isfinite(m['ctc_loss']) and reader.nonfinite_steps == 0
    print('resumed step: parameters and Adam state bit-equal to the '
          "writer's next step")
    return path, dict(write_s=write_s, read_s=read_s, mb=mb), launches


def check_quantize_cli(path, card):
    """Phase 15, part 2: ``python -m nbasr_torch.cli quantize`` on the
    checkpoint; its JSON line, and every q and s equal to
    ``quant.quantize_tree`` run here on the file's parameters.  Returns
    (the file's parameters, the JSON line)."""
    out = path.with_name('latest.int8.npz')
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, '-m', 'nbasr_torch.cli', 'quantize', str(path),
         '--out', str(out)], cwd=pathlib.Path(__file__).resolve().parent,
        check=True, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    line = json.loads(run.stdout.strip().splitlines()[-1])
    params = from_flax({'params': checkpoint.unpackb(path.read_bytes())[
        'params']})
    want = quant.quantize_tree(params)
    got = quant.load_quantized(out)
    assert got.keys() == want.keys()
    for name, w in want.items():
        if isinstance(w, dict):
            assert torch.equal(got[name]['q'], w['q']), name
            assert torch.equal(got[name]['s'], w['s']), name
        else:
            assert torch.equal(got[name], w), name
    print(f'python -m nbasr_torch.cli quantize: {line} ({wall:.1f} s with '
          f'the interpreter start); every q and s equal to quantize_tree '
          f'[{card}]')
    assert 0.25 <= line['ratio'] <= 0.27, line
    assert line['int8_bytes'] == quant.quantized_size_bytes(want)[0]
    return params, line


def _serving_model(params, device, dtype=torch.float32):
    model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                      compute_dtype=dtype)
    missing, unexpected = model.load_state_dict(params, strict=False)
    assert not unexpected and set(missing) == {'data_norm.mean',
                                               'data_norm.variance'}
    return model


def check_int8_serving(params, device, card):
    """Phase 15, part 3: ``StreamingASR(quantize=True)`` on phase 4's
    streams in f32 and bf16 (18 fused launches a device step, no plain
    call), the card against the same int8 port on the CPU, int8 against f32
    on the card; the streamer's resident bytes after the caller drops its
    model; the dequantization's share of a device step.  Returns the
    readings and the f32 launches."""
    audio, valid = make_audio()
    model = _serving_model(params, device)
    f32, *_ = serve(model, audio, valid, device)
    serve(model, audio, valid, device, quantize=True)        # warm-up
    fused_cell.reset_launches()
    q32, tokens, lengths, steps, wall = serve(model, audio, valid, device,
                                              quantize=True)
    launches = dict(fused_cell.LAUNCHES)
    assert launches == {'kernel': 18 * steps, 'plain': 0}, (launches, steps)
    assert np.isfinite(q32).all() and q32.shape == f32.shape
    audio_s = float(valid.sum()) / SAMPLE_RATE
    cpu = torch.device('cpu')
    want, _, want_lengths, _, cpu_wall = serve(
        _serving_model(params, cpu), audio, valid, cpu, quantize=True)
    np.testing.assert_array_equal(lengths, want_lengths)
    err = float(np.abs(q32 - want).max())
    scale = float(np.abs(want).max())
    rel = float(np.linalg.norm(q32 - f32) / np.linalg.norm(f32))
    print(f'int8 serving f32: {steps} device steps, launches {launches}, '
          f'wall {wall:.4f} s, {1e3 * wall / steps:.3f} ms per device step '
          f'(host included), {audio_s / wall:.1f} audio-s/s; card vs cpu '
          f'int8 logits max_abs_err={err:.3e} max|cpu|={scale:.3f} '
          f'(tol {SERVE_TOL * scale:.3e}, cpu run {cpu_wall:.1f} s); int8 vs '
          f'f32 relative L2 {rel:.4f} (tol {INT8_SERVE_TOL}: 2 x the CPU '
          f'reading {INT8_SERVE_CPU_READING}) [{card}]')
    assert err <= SERVE_TOL * scale
    assert rel <= INT8_SERVE_TOL

    low = _serving_model(params, device, torch.bfloat16)
    serve(low, audio, valid, device, quantize=True)          # warm-up
    fused_cell.reset_launches()
    qb16, _, _, bf16_steps, bf16_wall = serve(low, audio, valid, device,
                                              quantize=True)
    assert fused_cell.LAUNCHES == {'kernel': 18 * bf16_steps, 'plain': 0}
    rel_bf16 = float(np.linalg.norm(qb16 - q32) / np.linalg.norm(q32))
    print(f'int8 serving bf16: wall {bf16_wall:.4f} s, {audio_s / bf16_wall:.1f} '
          f'audio-s/s; vs int8 f32 relative L2 {rel_bf16:.4f} (tol '
          f'{BF16_SERVE_TOL}) [{card}]')
    assert np.isfinite(qb16).all() and rel_bf16 <= BF16_SERVE_TOL
    del low

    # resident weights: the int8 streamer alone, its caller's model dropped
    del model
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = _serving_model(params, device)
    f32_bytes = torch.cuda.memory_allocated() - base
    s = StreamingASR(model, chunk_frames=240, batch_size=B, device=device,
                     quantize=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() - base
    qbytes = sum(t['q'].numel() + 4 * t['s'].numel() if isinstance(t, dict)
                 else t.numel() * t.element_size()
                 for t in s.qparams.values())
    win = torch.randn((B, s.Wf, 80), generator=torch.Generator().manual_seed(
        SEED)).to(device)
    mask = torch.ones((B, s.Wf), dtype=torch.bool, device=device)
    step_ms = time_ms(lambda: s._device_step(win, mask, s.hl // s.ts,
                                             s._init_carry()), runs=20)
    deq_ms = time_ms(lambda: quant.dequantize_tree(s.qparams), runs=20)
    deq_dev_ms = device_ms(lambda: quant.dequantize_tree(s.qparams))
    n_q = sum(t['q'].numel() for t in s.qparams.values()
              if isinstance(t, dict))
    n_s = sum(t['s'].numel() for t in s.qparams.values()
              if isinstance(t, dict))
    deq_bytes = n_q + 4 * n_s + 4 * n_q          # int8 + scales in, f32 out
    deq_bound = 1e3 * deq_bytes / MEM_BYTES_S
    print(f'int8 streamer resident: {resident / 1e6:.3f} MB on the card '
          f'(its tensors {qbytes / 1e6:.3f} MB) against the f32 model\'s '
          f'{f32_bytes / 1e6:.3f} MB; device step {step_ms:.3f} ms (CUDA '
          f'events, median of 20), of which dequantization {deq_ms:.4f} ms '
          f'on events, {deq_dev_ms:.4f} ms device time '
          f'({deq_ms / step_ms:.1%}), bound {deq_bound:.4f} ms '
          f'({deq_bytes / 1e6:.1f} MB at {MEM_BYTES_S / 1e12:.2f} TB/s) '
          f'[{card}]')
    assert resident < 0.3 * f32_bytes, (resident, f32_bytes)
    return dict(steps=steps, wall=wall, audio_s_per_s=audio_s / wall,
                ms_per_step=1e3 * wall / steps, card_vs_cpu_share=err / scale,
                int8_vs_f32_rel_l2=rel, bf16_rel_l2=rel_bf16,
                resident_mb=resident / 1e6, f32_mb=f32_bytes / 1e6,
                step_ms=step_ms, dequant_ms=deq_ms,
                dequant_device_ms=deq_dev_ms, dequant_bound_ms=deq_bound,
                bf16_audio_s_per_s=audio_s / bf16_wall), launches['kernel']


def check_remat(device, card):
    """Phase 15, part 4: one fused bf16 step's gradients with
    ``remat_cells`` against one without, the same weights and generator
    seed: bit-equal, 36 forward and 18 backward fused launches, and the
    peak memory of each."""
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    batch = next(iter(loaders[1].full))
    out = {}
    for remat in (False, True):
        trainer = Trainer(loaders, device=device)
        trainer.init_state(_train_model(device, SEED, remat_cells=remat),
                           seed=SEED)
        trainer.gradients(batch)                    # warm-up: plans
        trainer.generator.manual_seed(SEED + 1)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused_cell.reset_launches()
        with recipe_seeds.deterministic():
            grads, m = trainer.gradients(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[remat] = (grads, m, dict(fused_cell.LAUNCHES),
                      dict(fused_cell.BACKWARD_LAUNCHES), peak)
        del trainer
    (g0, m0, f0, b0, p0), (g1, m1, f1, b1, p1) = out[False], out[True]
    print(f'remat_cells: launches forward {f1} backward {b1} (without: '
          f'{f0} {b0}); peak memory of the step {p1 / 1e9:.3f} GB against '
          f'{p0 / 1e9:.3f} GB without; loss {m1["ctc_loss"]:.6f} / '
          f'{m0["ctc_loss"]:.6f} [{card}]')
    assert f1 == {'kernel': 36, 'plain': 0} and b1 == {'kernel': 18, 'plain': 0}
    assert f0 == {'kernel': 18, 'plain': 0} and b0 == b1
    assert m0 == m1
    bad = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    assert not bad, bad[:5]
    print('remat_cells: every gradient bit-equal to the step without')
    return dict(peak_gb=p1 / 1e9, peak_gb_without=p0 / 1e9), (f1, b1)


def check_phase15(device):
    """Phase 15.  Returns (readings, launches by path)."""
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        path, ckpt, resumed = check_checkpoint(device, pathlib.Path(tmp),
                                               card)
        gc.collect()
        torch.cuda.empty_cache()
        params, line = check_quantize_cli(path, card)
    serving, int8_launches = check_int8_serving(params, device, card)
    remat, remat_launches = check_remat(device, card)
    return (dict(checkpoint=ckpt, quantize=line, int8_serving=serving,
                 remat=remat, card=card),
            dict(resumed=resumed, int8_forward=int8_launches,
                 remat=remat_launches))


# ---------------------------------------------------------------------------
# phase 16: the native host runtime, the sweep, static info and latency,
# data parallelism, the CLI and the entry points
# ---------------------------------------------------------------------------

REPO = pathlib.Path(__file__).resolve().parent
#: the flagship and an arch of linear, conv5d2 and conv7d2 nodes
P16_ARCHS = {'flagship': FLAGSHIP, 'linear+dilated': [[0, 1], [2, 1, 0],
                                                      [4, 0, 1, 1]]}
P16_SEED = 1234
FLAGSHIP_PARAMS = 26_339_349
BENCH_REPEATS = 20
#: seconds a subprocess or a pair of spawned ranks of phase 16 may take
P16_TIMEOUT_S = 600
FUSED_CELLS = sum(CELLS_PER_BLOCK)


def expected_counts(device, forwards=0, steps=0, evals=0, cells=FUSED_CELLS):
    """Launch counts of ``forwards`` eval forwards, ``steps`` train steps
    and ``evals`` eval batches (forward and the loss's alpha) of a model
    of ``cells`` fused cells: kernels on the card, the plain versions on
    the CPU (a rehearsal)."""
    used, other = (('kernel', 'plain') if device.type == 'cuda'
                   else ('plain', 'kernel'))
    count = lambda n: {used: n, other: 0}
    return {'fused_forward': count(cells * (forwards + steps + evals)),
            'fused_backward': count(cells * steps),
            'ctc_alpha': count(steps + evals), 'ctc_beta': count(steps)}


def _wav_bytes(audio, kind):
    """Seeded 16 kHz PCM16 bytes as RIFF or NIST SPHERE."""
    import struct
    pcm = (np.clip(audio, -1, 1) * 32767).astype('<i2').tobytes()
    if kind == 'riff':
        return (b'RIFF' + struct.pack('<I', 36 + len(pcm)) + b'WAVE'
                + b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, SAMPLE_RATE,
                                        SAMPLE_RATE * 2, 2, 16)
                + b'data' + struct.pack('<I', len(pcm)) + pcm)
    header = (f'NIST_1A\n   1024\nsample_rate -i {SAMPLE_RATE}\n'
              f'sample_n_bytes -i 2\nsample_byte_format -s2 01\n'
              f'channel_count -i 1\nend_head\n')
    return header.encode('ascii').ljust(1024, b' ') + pcm


def host_ms(fn, runs=5):
    """Median host milliseconds of ``fn`` (the card synchronised after)."""
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def check_native(device, card):
    """Phase 16, part 1: the native host runtime against the Python parser
    and, on phase 13's eval batch, against the card's edit distance and
    beam search.  Returns the readings."""
    from nbasr_torch.data import timit
    from nbasr_torch.ops.edit_distance import edit_distance
    assert native.available(), 'the native runtime did not build with g++'
    rng = np.random.RandomState(SEED + 16)
    audio = (rng.randn(int(AUDIO_SECONDS * SAMPLE_RATE)) * 0.2).astype(
        np.float32)
    out = {}
    for kind, parse in (('riff', timit._parse_riff),
                        ('sphere', timit._parse_sphere)):
        data = _wav_bytes(audio, kind)
        got, rate = native.parse_wav(data)
        want, want_rate = parse(data)
        err = float(np.abs(got - want).max())
        assert rate == want_rate == SAMPLE_RATE and got.shape == want.shape
        assert err <= 1e-6, (kind, err)
        out[f'parse_{kind}_ms'] = host_ms(lambda: native.parse_wav(data))
        out[f'parse_{kind}_python_ms'] = host_ms(lambda: parse(data))

    # phase 13's eval batch, its hypotheses and logits on the card
    model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                      generator=torch.Generator().manual_seed(SEED + 13))
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    trainer = Trainer(loaders, device=device, verbose=False)
    trainer.init_state(model, seed=SEED)
    batch = trainer._put_batch(next(iter(loaders[2])))
    with torch.no_grad():
        logits, lsize = trainer._eval_logits(batch)
    hyp, hyp_len, scores = decode._beam_search(logits, lsize, EVAL_BEAM,
                                               None, 0)
    refs = (batch['labels'], batch['label_size'])
    on_card = edit_distance(hyp, hyp_len, *refs)
    host = [t.cpu().numpy() for t in (hyp, hyp_len, *refs)]
    got = native.levenshtein(*host)
    assert np.array_equal(got, on_card.cpu().numpy()), (got, on_card)
    out['levenshtein_ms'] = host_ms(lambda: native.levenshtein(*host))
    out['edit_distance_card_ms'] = host_ms(
        lambda: edit_distance(hyp, hyp_len, *refs))

    lp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
    lens = lsize.cpu().numpy()
    ids, n = native.beam_search(lp, lens, beam_width=EVAL_BEAM)
    top2 = scores.topk(2, dim=1).values.cpu()
    clear = (((top2[:, 0] - top2[:, 1]) > BEAM_MARGIN)
             & (batch['valid'].cpu() > 0)).numpy()
    hyp, hyp_len = hyp.cpu().numpy(), hyp_len.cpu().numpy()
    same = np.array([ids[b, :n[b]].tolist() == hyp[b, :hyp_len[b]].tolist()
                     for b in range(len(n))])
    out['beam_rows_compared'] = int(clear.sum())
    out['beam_host_ms'] = host_ms(
        lambda: native.beam_search(lp, lens, beam_width=EVAL_BEAM), runs=3)
    out['beam_card_ms'] = host_ms(
        lambda: decode._beam_search(logits, lsize, EVAL_BEAM, None, 0), runs=3)
    print(f'native: built with g++ ({native._target().name}); parse_wav RIFF '
          f'{out["parse_riff_ms"]:.3f} ms / SPHERE {out["parse_sphere_ms"]:.3f}'
          f' ms for {AUDIO_SECONDS:g} s (Python {out["parse_riff_python_ms"]:.3f}'
          f' / {out["parse_sphere_python_ms"]:.3f} ms), equal within 1e-6; '
          f'levenshtein on phase 13\'s {tuple(hyp.shape)} beam hypotheses '
          f'{out["levenshtein_ms"]:.3f} ms, equal to edit_distance on the '
          f'card ({out["edit_distance_card_ms"]:.3f} ms); host beam search '
          f'W={EVAL_BEAM} {out["beam_host_ms"]:.3f} ms against the card\'s '
          f'{out["beam_card_ms"]:.3f} ms, ids equal on {int(same[clear].sum())}'
          f'/{int(clear.sum())} valid rows whose best two beams differ by '
          f'more than {BEAM_MARGIN:g} ({int(same.sum())}/{len(same)} in all) '
          f'[{card}]')
    assert clear.sum() > 0 and same[clear].all()
    return out


def _db_rows(path):
    with open(path, 'rb') as f:
        pickle.load(f)
        return pickle.load(f)


def check_sweep(device, root, card):
    """Phase 16, part 2: ``run_sweep`` of the two archs x one seed x one
    epoch on the train data, B=32, beam eval, in f32; its launches, its
    file read back, the resume replay (no launch, the same bytes), and the
    same sweep on two worker threads sharing the card.  Returns the
    readings and the launches of the first run."""
    archs = list(P16_ARCHS.values())
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    steps, evals = loaders[1].steps, len(list(loaders[2])) + len(
        list(loaders[3]))
    want = expected_counts(device, steps=len(archs) * steps,
                           evals=len(archs) * evals)
    kw = dict(seeds=(P16_SEED,), data_root=TRAIN_DATA, batch_size=TRAIN_B,
              epochs=1, devices=[device], progress=True)
    out = {}
    with recipe_seeds.deterministic(), timed_plans() as plans:
        reset_launches()
        t0 = time.perf_counter()
        (path,) = run_sweep(archs, out_dir=str(root / 'sweep'), **kw)
        out['wall_s'] = time.perf_counter() - t0
    launches = launch_counts()
    assert launches == want, (launches, want)
    out['plan_s'] = plans['s']
    db = nbasr_torch.from_folder(root / 'sweep', max_epochs=1, devices=False)
    rows = {}
    for name, arch in P16_ARCHS.items():
        info = db.full_info(arch, seed=P16_SEED)
        assert len(info['val_per']) == 1 and np.isfinite(info['test_per'])
        rows[name] = (info['val_per'][0], info['test_per'])
    first = path.read_bytes()

    reset_launches()
    (again,) = run_sweep(archs, out_dir=str(root / 'sweep'), **kw)
    assert launches_zero(launch_counts()), launch_counts()
    assert again.read_bytes() == first

    with recipe_seeds.deterministic():
        reset_launches()
        t0 = time.perf_counter()
        (threaded,) = run_sweep(archs, out_dir=str(root / 'threads'),
                                workers=2, **kw)
        out['wall_s_workers2'] = time.perf_counter() - t0
    threaded_launches = launch_counts()
    assert threaded_launches == want, (threaded_launches, want)
    assert _db_rows(threaded) == _db_rows(path), (_db_rows(threaded),
                                                  _db_rows(path))
    jobs = len(archs)
    print(f'sweep: {jobs} archs x seed {P16_SEED} x 1 epoch ({steps} train '
          f'steps and {evals} beam eval batches a job, B={TRAIN_B}, f32): '
          f'{out["wall_s"]:.1f} s, {out["wall_s"] / jobs:.1f} s per '
          f'arch-epoch, planning {plans["s"]:.2f} s ({plans["plans"]} plans, '
          f'{plans["s"] / out["wall_s"]:.0%}); launches {launches}; PER '
          f'(val, test) {rows}; the replay launched nothing and wrote the '
          f'same {len(first)} bytes; workers=2 on the one card '
          f'{out["wall_s_workers2"]:.1f} s, the same rows and launches '
          f'[{card}]')
    out['rows'] = rows
    return out, launches, threaded_launches


def launches_zero(counts):
    return all(v == 0 for c in counts.values() for v in c.values())


def check_static_and_latency(device, root, card):
    """Phase 16, part 3: ``static_info_pass`` on the two archs (the
    flagship's 26,339,349 parameters), ``benchmark_pass`` on them and
    ``unique_architectures(2)`` (18 fused launches a forward, 21 forwards
    an arch), the latency table read back by ``from_folder``.  Returns the
    readings and the launches."""
    from nbasr_torch.parallel.sweep import device_key
    archs = list(P16_ARCHS.values())
    info = static_info_pass(archs, out_dir=str(root / 'sweep'), device=device)
    db = nbasr_torch.from_folder(root / 'sweep', max_epochs=1,
                                 include_static_info=True, devices=False)
    assert db.params(FLAGSHIP) == FLAGSHIP_PARAMS, db.params(FLAGSHIP)
    static = {name: (db.params(a), db.flops(a))
              for name, a in P16_ARCHS.items()}
    bench = archs + [a for a in unique_architectures(2).values()
                     if a not in archs]
    reset_launches()
    t0 = time.perf_counter()
    path = benchmark_pass(bench, out_dir=str(root / 'sweep'),
                          repeats=BENCH_REPEATS, device=device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = expected_counts(device, forwards=len(bench) * (BENCH_REPEATS + 1))
    assert launches == want, (launches, want)
    key = device_key(device)
    assert path.name == f'nb-asr-bench-{key}.pickle'
    db = nbasr_torch.from_folder(root / 'sweep', max_epochs=1, devices=[key])
    ms = {}
    for arch in bench:
        (row,) = db.latency(arch, devices=key)
        ms[search_space.get_model_hash(arch)] = 1e3 * row[0]
    print(f'static info: {info.name}, (params, algorithmic flops of a B=1, '
          f'500-frame forward) {static}; benchmark_pass: {len(bench)} archs x '
          f'{BENCH_REPEATS} f32 forwards at B=1, T=500 in {wall:.1f} s, '
          f'median ms per forward ' + ', '.join(
              f'{h[:8]} {v:.3f}' for h, v in ms.items())
          + f'; {path.name} read back by from_folder(devices=[{key!r}]); '
          f'launches {launches} [{card}]')
    return dict(static=static, bench_ms=ms, key=key), launches


def _dp_model(device, seed):
    """Phase 16 (c)'s model: the flagship in f32 with no dropout."""
    return get_model(FLAGSHIP, use_rnn=True, dropout_rate=0.0,
                     cell_dropout=0.0, data_norm=True, device=device,
                     generator=torch.Generator().manual_seed(seed))


def _allreduce_ms(numel, device, group=None, runs=5):
    """Median ms of one all-reduce of ``numel`` f32 on ``device`` (the
    gradient bytes of one step in one tensor)."""
    import torch.distributed as dist
    flat = torch.ones(numel, dtype=torch.float32, device=device)
    return host_ms(lambda: dist.all_reduce(flat, group=group), runs=runs)


def _dp_rank(rank, world, device, seed, data, batch_size):
    """One of phase 16 (c)'s gloo ranks: the gradients before clipping of
    its half of the train batch (rank 0 returns them), its launches, and
    the ms of an all-reduce of the step's gradients."""
    torch.backends.cudnn.allow_tf32 = False       # f32 means f32 here too
    torch.backends.cuda.matmul.allow_tf32 = False
    loaders = get_dataloaders(data, batch_size=batch_size, num_shards=world,
                              shard_index=rank)
    batch = next(iter(loaders[1].full))
    trainer = ParallelTrainer(loaders, device=device, verbose=False)
    trainer.init_state(_dp_model(device, seed), seed=seed)
    trainer.gradients(batch)                      # warm-up: plans
    reset_launches()
    with recipe_seeds.deterministic():
        grads, m = trainer.gradients(batch)
    launches = launch_counts()
    ms = _allreduce_ms(count_params(trainer.model), device, trainer.group)
    return (({k: v.cpu() for k, v in grads.items()} if rank == 0 else None),
            m, launches, ms, len(batch['valid']))


def check_data_parallel(device, root, card):
    """Phase 16, part 4: (a) the train twin under torchrun at --dp 1; (b)
    ParallelTrainer over NCCL at world size 1, one bf16 step against the
    plain Trainer's; (c) two gloo ranks on the one card against one
    rank's gradients on the whole batch.  Returns the readings and the
    launches."""
    import torch.distributed as dist
    from nbasr_torch.parallel.mesh import free_port, spawn
    out, launches = {}, {}
    flat = [str(v) for v in flatten(FLAGSHIP)]
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', '1', '-m', 'nbasr_torch.train', *flat,
           '--dp', '1', '--data', TRAIN_DATA, '--batch_size', str(TRAIN_B),
           '--epochs', '1', '--device', device.type, '--exp_folder',
           str(root / 'dp1')]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=P16_TIMEOUT_S)
    out['torchrun_s'] = time.perf_counter() - t0
    if run.returncode:
        print(run.stdout[-4000:], run.stderr[-4000:])
    assert run.returncode == 0, ('torchrun --dp 1', run.returncode)
    scores = list((root / 'dp1' / 'torch').rglob('test_scores.pickle'))
    assert len(scores) == 1, scores
    print(f'torchrun --nproc_per_node 1 -m nbasr_torch.train ... --dp 1: '
          f'exit 0 in {out["torchrun_s"]:.1f} s, '
          f'{scores[0].relative_to(root)} written; its last line: '
          f'{run.stdout.strip().splitlines()[-1][:200]}')

    # (b) world size 1 over NCCL against the plain Trainer
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=f'tcp://127.0.0.1:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
        batch = next(iter(loaders[1].full))
        plain = Trainer(loaders, device=device)
        plain.init_state(_train_model(device, SEED), seed=SEED)
        par = ParallelTrainer(loaders, device=device)
        par.init_state(_train_model(device, SEED), seed=SEED)
        with recipe_seeds.deterministic():
            plain.step(batch, lr=1e-4)
            reset_launches()
            m = par.step(batch, lr=1e-4)
        launches['world1_step'] = launch_counts()
        assert launches['world1_step'] == expected_counts(device, steps=1)
        bad = _bit_equal_states(plain, par)
        assert not bad, bad[:5]
        assert np.isfinite(m['ctc_loss'])
        out['allreduce_ms_world1'] = _allreduce_ms(
            count_params(par.model), device, par.group)
        print(f'ParallelTrainer, world size 1 over {backend}: one bf16 '
              f'B={TRAIN_B} step, launches {launches["world1_step"]}, '
              f'parameters and Adam state bit-equal to the plain Trainer\'s '
              f'step (cuDNN deterministic); all-reduce of the step\'s '
              f'{count_params(par.model):,} f32 gradients in one tensor '
              f'{out["allreduce_ms_world1"]:.3f} ms [{card}]')
        del plain, par
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (c) two gloo ranks on the one card against one rank's whole batch
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    batch = next(iter(loaders[1].full))
    nudged = dict(batch, audio=(batch['audio'] * (1 + 1e-7 * np.random.RandomState(
        SEED).randn(*batch['audio'].shape))).astype(np.float32))
    single = Trainer(loaders, device=device, verbose=False)
    single.init_state(_dp_model(device, SEED), seed=SEED)
    single.gradients(batch)                       # warm-up: plans
    with recipe_seeds.deterministic():
        want, want_m = single.gradients(batch)
        near, _ = single.gradients(nudged)
    want = {k: v.cpu() for k, v in want.items()}
    near = {k: v.cpu() for k, v in near.items()}
    del single
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(_dp_rank, [device, device], (SEED, TRAIN_DATA, TRAIN_B),
                  timeout=P16_TIMEOUT_S)
    out['gloo_s'] = time.perf_counter() - t0
    got, got_m, _, _, rows = ranks[0]
    for r, (_, m, counts, ms, n) in enumerate(ranks):
        assert counts == expected_counts(device, steps=1), (r, counts)
        assert m['ctc_loss'] == ranks[0][1]['ctc_loss']
    launches['gloo_rank_step'] = ranks[0][2]
    out['allreduce_ms_gloo2'] = ranks[0][3]

    def shares(a, ref):
        return {n: float((a[n] - w).abs().max()) / max(float(w.abs().max()),
                                                       1e-30)
                for n, w in ref.items()}

    assert got.keys() == want.keys()
    bounds = kernel_grad_bounds(shares(near, want))
    honest, honest_at = over_bound(shares(got, want), bounds)
    planted, planted_at = over_bound(
        shares({n: 2 * g for n, g in got.items()}, want), bounds)
    print(f'two gloo ranks on the one card, f32, dropout 0, B={rows} each: '
          f'loss {got_m["ctc_loss"]:.6f} against one rank on B={TRAIN_B} '
          f'{want_m["ctc_loss"]:.6f}; gradients before clipping at '
          f'{honest:.3f} of their bound ({honest_at}), bound per tensor '
          f'min({KERNEL_GRAD_CAP:g}, max({KERNEL_GRAD_TOL:g}, '
          f'{KERNEL_GRAD_FACTOR:g} x the 1-ulp audio nudge)) '
          f'{min(bounds.values()):.2e} to {max(bounds.values()):.2e}: passed; '
          f'a planted world-size factor at {planted:.1f} of its bound '
          f'({planted_at}): rejected; launches a rank {ranks[0][2]}; '
          f'all-reduce of the step\'s gradients over gloo '
          f'{out["allreduce_ms_gloo2"]:.3f} ms; {out["gloo_s"]:.1f} s with '
          f'the processes\' start [{card}]')
    assert planted > 1.0, ('the check passed a world-size factor', planted)
    assert honest <= 1.0, ('two ranks against one', honest_at, honest)
    out.update(gloo_over_bound=honest, planted_over_bound=planted,
               loss=got_m['ctc_loss'], loss_one_rank=want_m['ctc_loss'])
    return out, launches


def check_cli_and_entry(device, root, card):
    """Phase 16, part 5: the CLI's sweep, info and benchpass in
    subprocesses, then ``entry()``'s forward (18 fused launches).  Returns
    the readings and the entry's launches."""
    out = {}
    for cmd in (['sweep', '--archs', '1', '--seeds', str(P16_SEED),
                 '--data', TRAIN_DATA, '--epochs', '1', '--batch_size',
                 str(TRAIN_B)], ['info', '--archs', '2'],
                ['benchpass', '--archs', '2']):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, '-m', 'nbasr_torch.cli', *cmd, '--device',
             device.type, '--out', str(root / 'cli')], cwd=REPO,
            capture_output=True, text=True, timeout=P16_TIMEOUT_S)
        if run.returncode:
            print(run.stdout[-4000:], run.stderr[-4000:])
        assert run.returncode == 0, (cmd, run.returncode)
        written = pathlib.Path(run.stdout.strip().splitlines()[-1])
        assert written.exists(), written
        out[cmd[0] + '_s'] = time.perf_counter() - t0
        print(f'python -m nbasr_torch.cli {" ".join(cmd)}: exit 0 in '
              f'{out[cmd[0] + "_s"]:.1f} s, wrote {written.name}')
    fn, args = entry.entry(device=device)
    fn(*args)                                     # warm-up: plans
    reset_launches()
    logits = fn(*args)
    torch.cuda.synchronize()
    launches = launch_counts()
    assert launches == expected_counts(device, forwards=1), launches
    assert bool(torch.isfinite(logits).all()) and logits.shape[0] == 2
    print(f'entry(): the flagship forward at B=2, T=296, logits '
          f'{tuple(logits.shape)}, launches {launches} [{card}]')
    return out, launches


def check_phase16(device):
    """Phase 16.  Returns (readings, launches by part)."""
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        native_r = check_native(device, card)
        sweep_r, sweep_l, threads_l = check_sweep(device, root, card)
        static_r, bench_l = check_static_and_latency(device, root, card)
        gc.collect()
        torch.cuda.empty_cache()
        dp_r, dp_l = check_data_parallel(device, root, card)
        cli_r, entry_l = check_cli_and_entry(device, root, card)
    return (dict(native=native_r, sweep=sweep_r, static=static_r,
                 data_parallel=dp_r, cli=cli_r, card=card),
            dict(sweep=sweep_l, sweep_workers2=threads_l, benchmark=bench_l,
                 world1_step=dp_l['world1_step'],
                 gloo_rank_step=dp_l['gloo_rank_step'], entry=entry_l))


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism and seq_parallel_apply
# ---------------------------------------------------------------------------

P17_TP = 2
P17_B = 16              # (b): the tp=2 f32 step's batch
P17_DP_B = 32           # (c): dp=2 x tp=2, the global batch
P17_PALLAS_B = 8
P17_TIMED_STEPS = 5
P17_SEQ_B, P17_SEQ_T = 2, 2176    # a shard of 544 frames > the halo of 532
#: seq_parallel_apply against the unsharded forward, of max|logits|: the
#: windows sum in other orders only where the LayerNorms and the LSTM do
P17_SEQ_TOL = 1e-4
P17_TIMEOUT_S = 600
#: seeds of the 1e-7 audio nudge among phase 17's gradient witnesses
P17_NUDGES = 3
# Phase 17 holds the gathered gradients of a parallel step to phase 8's
# rule, min(0.1, max(1e-3, factor x witness)) of each tensor's max, on the
# largest move of its witnesses: three 1e-7 nudges of the audio, for
# 'auto' and 'pallas' the cells in the other kernels, and for 'auto' the
# cells' LayerNorm outside the fused kernel in the shard's arithmetic
# ('pallas_split' has the nudges only: its gate passes nothing at exactly
# 0 or 20, the other paths' half).  The factor is 4 where phase 8 takes 2:
# on an H100 (700 W) the tp=2 'auto' step moved one tensor, block3_cell0's
# first conv kernel gradient, 1.317e-2 of its max where the largest
# witness moved it 5.915e-3 (2.23x); every other tensor of that step, and
# every tensor of the 'pallas' tp=2 and dp=2 x tp=2 steps, read at most
# 1.71x.  That gap is the f32 rounding of a badly conditioned gradient,
# not a fault: on the CPU, block 3 (C=1200, 100 groups, T=75, six cells,
# the LSTM) at tp=2 agrees with one process to 4.2e-15 of each tensor's
# max in float64, where in float32 it reads 1.10e-2 and one process's f32
# gradients lie up to 2.57x a tensor's max from its f64 ones
# (``python -m nbasr_torch.tools.tp_gap``).  A planted sliced-gradient
# fault moves a tensor 1.0 of its max.
P17_WITNESS_FACTOR = 4.0
#: (e'): the ranks' weights of ``Σ w·logits`` are drawn from this seed
P17_SEQ_W_SEED = SEED + 17


@torch.no_grad()
def check_shard_kernels(device):
    """Phase 17 (a): kernel #1 (and #2) at the tp=2 shard shapes: the
    flagship cell on C/2 = 300/400/500/600 channels in 50 groups, no
    LayerNorm, dropout 0.2 at channel offset c0 = C/2 (model rank 1), f32
    and bf16, against the plain versions (masks exact, two calls
    bit-equal); the shard's dropped elements are the whole cell's on its
    channels."""
    seed = torch.tensor(TRAIN_SEED, dtype=torch.int32, device=device)
    checker = TrainKernelCheck(seed)
    for C_full, T in TRAIN_WIDTHS:
        C = C_full // P17_TP
        g = torch.Generator().manual_seed(SEED + C + T)
        x32 = torch.randn((CHECK_B, T, C), generator=g).to(device)
        dy32 = torch.randn((CHECK_B, T, C), generator=g).to(device)
        cell = make_cell(C, SPECS['flagship no-norm'], device,
                         groups=WIDE_GROUPS)
        spec = FusedCellSpec(cell.spec.nodes, dropout_rate=DROPOUT,
                             train=True, use_norm=False, channel_offset=C)
        for dtype in (torch.float32, torch.bfloat16):
            checker.check(f'shard c0={C}', spec, x32.to(dtype),
                          dy32.to(dtype), *cell.operands(dtype))
        whole = fused_cell.dropout_bits(seed, 1, CHECK_B, T, C_full)
        assert torch.equal(whole[..., C:], fused_cell.dropout_bits(
            seed, 1, CHECK_B, T, C, c0=C)), 'shard masks'
    return checker


def _p17_model(device, seed, dropout, **kw):
    """The full-width flagship of phase 17, f32 unless ``kw`` says."""
    return get_model(FLAGSHIP, use_rnn=True, dropout_rate=dropout,
                     cell_dropout=dropout, data_norm=True, device=device,
                     generator=torch.Generator().manual_seed(seed), **kw)


def _two_pass_norm(norm, x):
    """``norm`` (a cell's LayerNorm) as a channel-parallel shard's
    DistributedLayerNorm writes it, on one shard: two-pass f32 statistics
    in elementary ops, the backward by autograd."""
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) / xf.shape[-1]
    d = xf - mu
    var = torch.square(d).sum(-1, keepdim=True) / xf.shape[-1]
    return (d * torch.rsqrt(var + norm.epsilon) * norm.scale
            + norm.bias).to(x.dtype)


def _norm_outside_kernels(model):
    """Take every cell's LayerNorm out of its fused kernel, as a
    channel-parallel shard runs its cells: the kernel without LayerNorm,
    then the shard's LayerNorm arithmetic on the whole row
    (:func:`_two_pass_norm`)."""
    for cell in model.modules():
        if isinstance(cell, SearchCell) and cell.spec.use_norm:
            for attr in ('spec', 'train_spec'):
                s = getattr(cell, attr)
                setattr(cell, attr, FusedCellSpec(
                    s.nodes, dropout_rate=s.dropout_rate, train=s.train,
                    ln_eps=s.ln_eps, use_norm=False,
                    channel_offset=s.channel_offset))
            cell.norm.forward = functools.partial(_two_pass_norm, cell.norm)
    return model


def _p17_reference(device, seed, B, dropout, grouped_impl='auto'):
    """One process's f32 gradients before clipping on ``B`` rows (on the
    dropout masks of the ranks' stream), and witnesses of how far the same
    function moves them: the audio nudged by one part in 10^7 (three
    draws), the cells in the other kernels (``'pallas'`` for ``'auto'``
    and back: the same function with its sums and LayerNorm statistics
    taken in other orders, as tensor parallelism takes them; none for
    ``'pallas_split'``, whose gate differs from theirs at exact ties), and
    for ``'auto'`` the cells' LayerNorm outside the fused kernel (the one
    change of a cell's arithmetic that tensor parallelism makes beyond
    its channel split): (gradients, {witness: gradients}, loss), on the
    CPU."""
    loaders = get_dataloaders(TRAIN_DATA, batch_size=B)
    batch = next(iter(loaders[1].full))
    nudged = [dict(batch, audio=(batch['audio'] * (
        1 + 1e-7 * np.random.RandomState(SEED + s).randn(
            *batch['audio'].shape))).astype(np.float32))
        for s in range(P17_NUDGES)]
    other = {'auto': 'pallas', 'pallas': 'auto'}.get(grouped_impl)
    names = [f'nudge {s}' for s in range(P17_NUDGES)]
    runs = [(grouped_impl, (batch, *nudged), None)]
    if other:
        names.append(f'{other} cells')
        runs.append((other, (batch,), None))
    if grouped_impl == 'auto':
        names.append('norm outside the kernel')
        runs.append((grouped_impl, (batch,), _norm_outside_kernels))
    out, loss = [], None
    for impl, batches, change in runs:
        model = _p17_model(device, seed, dropout, grouped_impl=impl)
        single = Trainer(loaders, device=device, verbose=False)
        single.init_state(change(model) if change else model, seed=seed)
        state = single.generator.get_state()
        single.gradients(batch)                   # warm-up: plans
        with recipe_seeds.deterministic():
            for b in batches:
                single.generator.set_state(state)
                grads, m = single.gradients(b)
                out.append({k: v.cpu() for k, v in grads.items()})
                loss = m['ctc_loss'] if loss is None else loss
        del single, model
        gc.collect()
        torch.cuda.empty_cache()
    return out[0], dict(zip(names, out[1:])), loss


def _p17_shares(got, want):
    return {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-30)
            for n, w in want.items()}


def _p17_local_shapes_ok(model, tp):
    """Every parameter's local shape is what ``param_spec`` says."""
    from nbasr_torch.parallel.mesh import param_spec
    for name, p in model.named_parameters():
        full = model.tp_full_shapes[name]
        pl = param_spec(name, torch.empty(full, device='meta'), tp)[1]
        want = list(full)
        if pl.is_shard():
            want[pl.dim] //= tp
        if list(p.shape) != want:
            return name
    return None


def _p17_gradients(trainer, batch, fault=False):
    """The gathered gradients (on the CPU, rank 0's; None elsewhere), the
    loss and the launches of one ``gradients`` call, on the masks the
    trainer's generator holds now; ``fault`` leaves the sliced parameters'
    gradients unsummed over 'model'."""
    import torch.distributed as dist
    from nbasr_torch.parallel import tensor
    state = trainer.generator.get_state()
    if fault:
        trainer._sum_sliced_grads = lambda: None
    _p17_reset()
    with recipe_seeds.deterministic():
        grads, m = trainer.gradients(batch)
    launches = _p17_counts()
    trainer.__dict__.pop('_sum_sliced_grads', None)
    trainer.generator.set_state(state)
    full = tensor.gather_named(trainer.model, grads)
    return ({k: v.cpu() for k, v in full.items()} if dist.get_rank() == 0
            else None, m['ctc_loss'], launches)


def _p17_reset():
    reset_launches()
    grouped_conv.reset_launches()


def _p17_counts():
    """Phase 16's launch counts and the grouped conv kernels'."""
    return {**launch_counts(), **{f'gconv_{k}': dict(v) for k, v in
                                  grouped_conv.LAUNCHES.items()}}


def _p17_expected(device, steps=0, forwards=0, grouped=0):
    """Launch counts of ``steps`` fused train steps and ``forwards``
    forwards, or (``grouped``) of that many grouped train steps."""
    used, other = (('kernel', 'plain') if device.type == 'cuda'
                   else ('plain', 'kernel'))
    count = lambda n: {used: n, other: 0}
    out = {**expected_counts(device, forwards=forwards, steps=steps),
           **{f'gconv_{k}': count(0) for k in GCONV_KERNELS}}
    if grouped:
        out.update({f'gconv_{k}': count(3 * FUSED_CELLS * grouped)
                    for k in GCONV_KERNELS},
                   fused_forward=count(0), fused_backward=count(0),
                   ctc_alpha=count(grouped), ctc_beta=count(grouped))
    return out


def _p17_timed_collectives(tensor, spent):
    """Wrap the tensor-parallel collectives so ``spent[0]`` adds up their
    seconds (the card synchronised around each)."""
    depth = [0]

    def timed(fn):
        def wrapper(*args, **kwargs):
            depth[0] += 1
            if depth[0] == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    torch.cuda.synchronize()
                    spent[0] += time.perf_counter() - t0
        return wrapper
    for name in ('_all_gather', '_all_reduce', '_reduce_scatter'):
        setattr(tensor, name, timed(getattr(tensor, name)))


def _p17_tp_rank(rank, world, device, seed):
    """Phase 17 (b), the 'pallas' step of (c), (b') and (d), on one of two
    gloo ranks at (dp, tp) = (1, 2)."""
    from nbasr_torch.parallel import make_mesh, tensor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(dp=1, tp=world)
    out = {}
    for name, B, dropout, impl in (('auto', P17_B, DROPOUT, 'auto'),
                                   ('pallas', P17_PALLAS_B, DROPOUT,
                                    'pallas'),
                                   ('pallas_split', P17_PALLAS_B, DROPOUT,
                                    'pallas_split')):
        loaders = get_dataloaders(TRAIN_DATA, batch_size=B)
        batch = next(iter(loaders[1].full))
        trainer = ParallelTrainer(loaders, device=device, mesh=mesh,
                                  verbose=False)
        trainer.init_state(_p17_model(device, seed, dropout,
                                      grouped_impl=impl), seed=seed)
        state = trainer.generator.get_state()
        trainer.gradients(batch)                  # warm-up: plans
        trainer.generator.set_state(state)
        grads, loss, launches = _p17_gradients(trainer, batch)
        reading = dict(grads=grads, loss=loss, launches=launches,
                       shape_fault=_p17_local_shapes_ok(trainer.model, world),
                       channel_cells=sum(isinstance(m, tensor.ChannelCell)
                                         for m in trainer.model.modules()))
        if name in ('auto', 'pallas_split'):
            reading['fault'] = _p17_gradients(trainer, batch, fault=True)[0]
        out[name] = reading
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    # (d) one bf16 step at the train step's batch, timed
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B)
    batch = next(iter(loaders[1].full))
    trainer = ParallelTrainer(loaders, device=device, mesh=mesh,
                              verbose=False)
    trainer.init_state(_p17_model(device, seed, DROPOUT,
                                  compute_dtype=torch.bfloat16), seed=seed)
    for _ in range(2):
        trainer.step(batch, lr=1e-4)              # warm-up: plans
    spent = [0.0]
    _p17_timed_collectives(tensor, spent)
    tensor.reset_staged()
    _p17_reset()
    walls = []
    for _ in range(P17_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch, lr=1e-4)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out['bf16'] = dict(step_ms=1e3 * float(np.median(walls)),
                       collective_ms=1e3 * spent[0] / P17_TIMED_STEPS,
                       staged=dict(tensor.STAGED), launches=_p17_counts(),
                       loss=m['ctc_loss'])
    return out


def _p17_seq_feats(device):
    feats = torch.as_tensor(np.random.RandomState(SEED).randn(
        P17_SEQ_B, P17_SEQ_T, 80).astype(np.float32), device=device)
    sizes = torch.as_tensor([P17_SEQ_T, P17_SEQ_T - 300], dtype=torch.int32,
                            device=device)
    return feats, sizes


def _p17_seq_weights(device):
    """The weights ``w`` of phase 17 (e')'s ``Σ w·logits``, ``[B, T/4,
    V]``."""
    return torch.as_tensor(np.random.RandomState(P17_SEQ_W_SEED).randn(
        P17_SEQ_B, P17_SEQ_T // 4, VOCAB).astype(np.float32), device=device)


@contextlib.contextmanager
def _p17_seq_fault(mode):
    """A planted fault in seq_parallel_apply's backward, on every rank
    alike (so no rank waits on a message that never comes): ``'chain'``
    drops the relayed carry's gradient, ``'gather'`` keeps each rank's
    slice of the gathered output's gradient without the sum over the
    ranks."""
    from nbasr_torch.parallel import seqparallel, tensor
    if mode == 'chain':
        honest = seqparallel._Relay.backward

        def dropped(fctx, g):
            g, dc, dh, *rest = honest(fctx, g)
            return (g, torch.zeros_like(dc), torch.zeros_like(dh), *rest)
        seqparallel._Relay.backward = staticmethod(dropped)
        try:
            yield
        finally:
            seqparallel._Relay.backward = staticmethod(honest)
    else:
        honest = tensor._reduce_scatter
        tensor._reduce_scatter = tensor._own
        try:
            yield
        finally:
            tensor._reduce_scatter = honest


def _p17_seq_gradients(model, shard, sizes, weights, mode, fault):
    """Phase 17 (e'): the gradients of ``Σ weights·logits`` through
    seq_parallel_apply on this rank's shard: the parameters' summed over
    the ranks (rank 0's, on the CPU; None elsewhere), this shard's
    features', and the launches of the call and its backward."""
    import torch.distributed as dist
    from nbasr_torch.parallel import seq_parallel_apply
    model.zero_grad(set_to_none=True)
    x = shard.clone().requires_grad_(True)
    dist.barrier()
    _p17_reset()
    with _p17_seq_fault(mode) if fault else contextlib.nullcontext():
        logits = seq_parallel_apply(model, x, sizes, lstm_mode=mode)
        (weights * logits).sum().backward()
    torch.cuda.synchronize()
    launches = _p17_counts()
    names = [n for n, _ in model.named_parameters()]
    grads = [p.grad for _, p in model.named_parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads]).cpu()
    dist.all_reduce(flat)
    params = None
    if dist.get_rank() == 0:     # copies: a pickled view carries all of flat
        params = dict(zip(names, (t.view_as(g).clone() for t, g in zip(
            flat.split([g.numel() for g in grads]), grads))))
    return dict(params=params, features=x.grad.cpu(), launches=launches)


def _p17_four_rank(rank, world, device, seed):
    """Phase 17 (c) at dp=2 x tp=2, then (e) seq_parallel_apply and (e')
    its gradients, on one of four gloo ranks."""
    import torch.distributed as dist
    from nbasr_torch.parallel import make_mesh, seq_parallel_apply
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(dp=2, tp=2)
    loaders = get_dataloaders(TRAIN_DATA, batch_size=P17_DP_B, num_shards=2,
                              shard_index=rank // 2)
    batch = next(iter(loaders[1].full))
    trainer = ParallelTrainer(loaders, device=device, mesh=mesh,
                              verbose=False)
    trainer.init_state(_p17_model(device, seed, 0.0), seed=seed)
    trainer.gradients(batch)                      # warm-up: plans
    grads, loss, launches = _p17_gradients(trainer, batch)
    out = dict(grads=grads, loss=loss, launches=launches,
               rows=len(batch['valid']))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    model = _p17_model(device, seed, 0.0).eval()
    feats, sizes = _p17_seq_feats(device)
    L = P17_SEQ_T // world
    shard = feats[:, rank * L:(rank + 1) * L].contiguous()
    for mode in ('chain', 'gather'):
        with torch.no_grad():
            seq_parallel_apply(model, shard, sizes, lstm_mode=mode)  # plans
            dist.barrier()
            _p17_reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = seq_parallel_apply(model, shard, sizes, lstm_mode=mode)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[mode] = dict(logits=logits.cpu(), wall_ms=1e3 * wall,
                         launches=_p17_counts())
    per = P17_SEQ_T // 4 // world
    weights = _p17_seq_weights(device)[:, rank * per:(rank + 1) * per]
    for mode in ('chain', 'gather'):
        out[f'grad_{mode}'] = _p17_seq_gradients(model, shard, sizes,
                                                 weights, mode, False)
        out[f'fault_{mode}'] = _p17_seq_gradients(model, shard, sizes,
                                                  weights, mode, True)
    return out


def _p17_seq_reference(device):
    """The unsharded model's gradients of phase 17 (e')'s ``Σ w·logits``
    (the parameters' and the features'), and those with the features
    nudged by one part in 10^7 (``P17_NUDGES`` draws), on the CPU."""
    model = _p17_model(device, SEED, 0.0).eval()
    feats, sizes = _p17_seq_feats(device)
    weights = _p17_seq_weights(device)
    out = []
    for s in (None, *range(P17_NUDGES)):
        x = feats if s is None else feats * (1 + 1e-7 * torch.as_tensor(
            np.random.RandomState(SEED + s).randn(*feats.shape).astype(
                np.float32), device=device))
        x = x.clone().requires_grad_(True)
        model.zero_grad(set_to_none=True)
        (weights * model(x, sizes)).sum().backward()
        out.append(dict({n: p.grad.cpu() for n, p in model.named_parameters()},
                        features=x.grad.cpu()))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out[0], out[1:]


def check_phase17(device):
    """Phase 17.  Returns (readings, launches by part)."""
    from nbasr_torch.parallel.mesh import spawn
    card = card_line()
    t0 = time.perf_counter()
    checker = check_shard_kernels(device)
    out = dict(card=card, shard_kernels=dict(
        errors={k: {str(d)[6:]: v for d, v in e.items()}
                for k, e in checker.errors.items()},
        gate_flips=checker.flips, compared=checker.compared,
        seconds=time.perf_counter() - t0))
    print(f'phase 17 (a): kernel #1 and #2 at the tp=2 shard shapes (C/2 = '
          f'300-600, 50 groups, no LayerNorm, dropout {DROPOUT} at c0 = C/2) '
          f'within their bounds, masks exact, two calls bit-equal; errors '
          f'{out["shard_kernels"]["errors"]} [{card}]')
    gc.collect()
    torch.cuda.empty_cache()
    want = {k: _p17_reference(device, SEED, B, d, impl) for k, B, d, impl in (
        ('auto', P17_B, DROPOUT, 'auto'),
        ('pallas', P17_PALLAS_B, DROPOUT, 'pallas'),
        ('pallas_split', P17_PALLAS_B, DROPOUT, 'pallas_split'),
        ('dp2', P17_DP_B, 0.0, 'auto'))}
    seq_want, seq_nudged = _p17_seq_reference(device)
    feats, sizes = _p17_seq_feats(device)
    model = _p17_model(device, SEED, 0.0).eval()
    with torch.no_grad():
        model(feats, sizes)                       # warm-up: plans
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain_logits = model(feats, sizes)
        torch.cuda.synchronize()
        unsharded_ms = 1e3 * (time.perf_counter() - t1)
    plain_logits = plain_logits.cpu()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    two = spawn(_p17_tp_rank, [device] * 2, (SEED,), timeout=P17_TIMEOUT_S)
    out['two_ranks_s'] = time.perf_counter() - t1
    t1 = time.perf_counter()
    four = spawn(_p17_four_rank, [device] * 4, (SEED,),
                 timeout=P17_TIMEOUT_S)
    out['four_ranks_s'] = time.perf_counter() - t1

    expected_step = _p17_expected(device, steps=1)
    launches = {}
    for label, reading, ref in (('tp2_auto', two[0]['auto'], want['auto']),
                                ('tp2_pallas', two[0]['pallas'],
                                 want['pallas']),
                                ('tp2_split', two[0]['pallas_split'],
                                 want['pallas_split']),
                                ('dp2_tp2', four[0], want['dp2'])):
        grads, witnesses, loss = ref
        moves = {k: _p17_shares(w, grads) for k, w in witnesses.items()}
        bounds = {n: min(KERNEL_GRAD_CAP, max(
            KERNEL_GRAD_TOL, P17_WITNESS_FACTOR * max(m[n] for m in
                                                      moves.values())))
            for n in grads}
        honest, at = over_bound(_p17_shares(reading['grads'], grads), bounds)
        row = dict(over_bound=honest, at=at, loss=reading['loss'],
                   loss_one_process=loss,
                   share=_p17_shares(reading['grads'], grads)[at])
        if 'fault' in reading:
            row['planted'], row['planted_at'] = over_bound(
                _p17_shares(reading['fault'], grads), bounds)
            assert row['planted'] > 1.0, ('a sliced-gradient fault passed',
                                          row['planted'])
        print(f'phase 17 {label}: gathered f32 gradients before clipping at '
              f'{honest:.3f} of their bound ({at}: share {row["share"]:.3e}; '
              + ', '.join(f'{k} {m[at]:.3e}' for k, m in moves.items())
              + f'), bound min({KERNEL_GRAD_CAP:g}, max({KERNEL_GRAD_TOL:g}, '
              f'{P17_WITNESS_FACTOR:g} x the largest witness)); loss '
              f'{reading["loss"]:.6f} against one process\'s {loss:.6f}'
              + (f'; a planted sliced-gradient fault at '
                 f'{row["planted"]:.1f} of its bound ({row["planted_at"]}): '
                 f'rejected' if 'planted' in row else '')
              + f'; launches a rank {reading["launches"]} [{card}]')
        assert honest <= 1.0, (label, at, honest)
        out[label] = row
    for r, ranks in enumerate(two):
        assert ranks['auto']['launches'] == expected_step, (r, ranks['auto'])
        for impl in ('pallas', 'pallas_split'):
            assert ranks[impl]['launches'] == _p17_expected(
                device, grouped=1), (r, impl, ranks[impl]['launches'])
        for impl in ('auto', 'pallas', 'pallas_split'):
            assert ranks[impl]['shape_fault'] is None, ranks[impl]
            assert ranks[impl]['channel_cells'] == FUSED_CELLS, ranks[impl]
        assert ranks['bf16']['launches'] == _p17_expected(
            device, steps=P17_TIMED_STEPS), ranks['bf16']
    for r, ranks in enumerate(four):
        assert ranks['launches'] == expected_step, (r, ranks['launches'])
    launches['tp2_step'] = two[0]['auto']['launches']
    launches['tp2_pallas_step'] = two[0]['pallas']['launches']
    launches['tp2_split_step'] = two[0]['pallas_split']['launches']
    launches['dp2_tp2_step'] = four[0]['launches']
    launches['bf16_steps'] = two[0]['bf16']['launches']
    bf16 = two[0]['bf16']
    out['bf16_step'] = {k: v for k, v in bf16.items() if k != 'launches'}
    print(f'phase 17 (d): one bf16 tp=2 step, B={TRAIN_B}, on two gloo ranks '
          f'of the one card: {bf16["step_ms"]:.3f} ms (median of '
          f'{P17_TIMED_STEPS}), the tensor-parallel collectives '
          f'{bf16["collective_ms"]:.3f} ms of it '
          f'({bf16["collective_ms"] / bf16["step_ms"]:.1%}), '
          f'{bf16["staged"]["copies"] / P17_TIMED_STEPS:.0f} host copies '
          f'({bf16["staged"]["bytes"] / P17_TIMED_STEPS / 1e6:.1f} MB) a step '
          f'through gloo [{card}]')

    scale = float(plain_logits.abs().max())
    for mode in ('chain', 'gather'):
        got = torch.cat([r[mode]['logits'] for r in four], dim=1)
        assert got.shape == plain_logits.shape, (got.shape, plain_logits.shape)
        err = float((got - plain_logits).abs().max()) / scale
        walls = [r[mode]['wall_ms'] for r in four]
        for r in four:
            assert r[mode]['launches'] == _p17_expected(
                device, forwards=1), r[mode]['launches']
        launches[f'seq_{mode}'] = four[0][mode]['launches']
        out[f'seq_{mode}'] = dict(err=err, wall_ms=max(walls),
                                  unsharded_ms=unsharded_ms)
        print(f'phase 17 (e): seq_parallel_apply ({mode}) on 4 gloo ranks, '
              f'f32, B={P17_SEQ_B}, T={P17_SEQ_T}: logits at {err:.2e} of '
              f'max|logits| of the unsharded forward (tol {P17_SEQ_TOL:g}); '
              f'{max(walls):.3f} ms a call (the slowest rank) against '
              f'{unsharded_ms:.3f} ms unsharded; launches a rank '
              f'{four[0][mode]["launches"]["fused_forward"]} [{card}]')
        assert err <= P17_SEQ_TOL, (mode, err)

    # (e') the gradients through the ranks against the unsharded model's
    moves = [_p17_shares(w, seq_want) for w in seq_nudged]
    bounds = {n: min(KERNEL_GRAD_CAP, max(KERNEL_GRAD_TOL, P17_WITNESS_FACTOR
                                          * max(m[n] for m in moves)))
              for n in seq_want}
    for mode in ('chain', 'gather'):
        got, bad = {}, {}
        for key, dest in ((f'grad_{mode}', got), (f'fault_{mode}', bad)):
            dest.update(four[0][key]['params'])
            dest['features'] = torch.cat([r[key]['features'] for r in four],
                                         dim=1)
        honest, at = over_bound(_p17_shares(got, seq_want), bounds)
        planted, planted_at = over_bound(_p17_shares(bad, seq_want), bounds)
        # one forward and one backward of the 18 cells, no loss
        none = _p17_expected(device)
        expected = dict(_p17_expected(device, steps=1),
                        ctc_alpha=none['ctc_alpha'], ctc_beta=none['ctc_beta'])
        for r in four:
            assert r[f'grad_{mode}']['launches'] == expected, \
                r[f'grad_{mode}']['launches']
        launches[f'seq_grad_{mode}'] = four[0][f'grad_{mode}']['launches']
        out[f'seq_grad_{mode}'] = dict(
            over_bound=honest, at=at, share=_p17_shares(got, seq_want)[at],
            planted=planted, planted_at=planted_at)
        print(f"phase 17 (e'): seq_parallel_apply ({mode}) gradients of "
              f'sum(w * logits) on 4 gloo ranks (parameters summed over the '
              f'ranks, the features\' shards joined) at {honest:.3f} of their '
              f'bound ({at}: share {out[f"seq_grad_{mode}"]["share"]:.3e}), '
              f'bound min({KERNEL_GRAD_CAP:g}, max({KERNEL_GRAD_TOL:g}, '
              f'{P17_WITNESS_FACTOR:g} x the largest move under '
              f'{P17_NUDGES} 1e-7 nudges of the features)) of the unsharded '
              f'model\'s; a planted fault ('
              + ('the relayed carry\'s gradient dropped' if mode == 'chain'
                 else 'the gathered gradient not summed over the ranks')
              + f') at {planted:.1f} of its bound ({planted_at}): rejected; '
              f'launches a rank {four[0][f"grad_{mode}"]["launches"]["fused_forward"]}'
              f' + {four[0][f"grad_{mode}"]["launches"]["fused_backward"]} '
              f'[{card}]')
        assert honest <= 1.0, (mode, at, honest)
        assert planted > 1.0, (mode, 'a planted fault passed', planted)
    return out, launches


# ---------------------------------------------------------------------------
# phase 18: the learning proof on the tone-coded corpus, int8 on trained
# weights
# ---------------------------------------------------------------------------

#: (c): epochs of the full-width flagship on per_run's recipe
P18_FLAGSHIP_EPOCHS = 3
#: (a): the recipe's init seeds.  Each run is judged by the JAX test's
#: three asserts (``recipe_seeds.passes``: best val LER < 0.5, the test
#: eval on the best weights < 0.6, epoch 1 > 0.6; the JAX test asserts
#: one draw of its own), and a majority of the runs must pass all three,
#: so the medians of the best and the test LER pass too.  cuDNN runs
#: deterministic, so a seed's run repeats bit for bit and the gate reads
#: the same on every call.  Within 40 epochs the recipe leaves a plateau
#: near 0.8 at an epoch that the init draw and the rounding decide, and
#: some draws start below 0.6 at epoch 1, with the kernels and without
#: them: PERF.md §6 gives 32 seeds' runs of both routes on an H100
#: (``python -m nbasr_torch.tools.recipe_seeds``)
P18_SEEDS = tuple(range(9))
P18_BEST_LER, P18_TEST_LER, P18_FIRST_LER = (
    recipe_seeds.BEST_LER, recipe_seeds.TEST_LER, recipe_seeds.FIRST_LER)
#: (b): int8 against f32 on each run's best weights: the CTC loss as a
#: share of f32's on every run, and the val PER apart on a majority of the
#: runs (the JAX package read equal PER and +1% loss).  The 8 val
#: utterances hold 35 phonemes, so one decoded phoneme moves the PER by
#: 0.029: past 0.02, and a half-trained run's near-tied beams flip under
#: int8 (seed 5 on an H100: PER 0.4857 against 0.4286, loss +0.04%)
P18_INT8_PER_TOL, P18_INT8_LOSS_TOL = 0.02, 0.05


def _batches(loader):
    return sum(1 for _ in loader)


@contextlib.contextmanager
def _recorded_cells(calls):
    """Inside, each cell backward appends the tensors it was given: (spec,
    x, dy, weights, ln), copies."""
    saved = fused_cell.fused_cell_backward

    def recorded(spec, x, outs, mults, dy, weights, ln):
        calls.append((spec, x.clone(), dy.clone(),
                      [w.detach().clone() for w in weights],
                      ln and [t.detach().clone() for t in ln]))
        return saved(spec, x, outs, mults, dy, weights, ln)

    fused_cell.fused_cell_backward = recorded
    try:
        yield
    finally:
        fused_cell.fused_cell_backward = saved


@torch.no_grad()
def _p18_kernels(calls):
    """#1 and #2 on the recipe's own tensors: each cell's input and output
    gradient from one step on the recipe's first train batch (B=8, padded
    frames included), under phase 6's check at dropout 0 (the recipe's)
    and 0.2; the eval forward on the same input within ``TOL``."""
    checker = TrainKernelCheck(torch.tensor(TRAIN_SEED, dtype=torch.int32,
                                            device=calls[0][1].device))
    worst = 0.0
    for i, (spec, x, dy, weights, ln) in enumerate(calls):
        for rate in (0.0, DROPOUT):
            checker.check(f'recipe cell {i}', FusedCellSpec(
                spec.nodes, dropout_rate=rate, train=True, ln_eps=spec.ln_eps,
                use_norm=spec.use_norm), x, dy, weights, ln)
        serve = FusedCellSpec(spec.nodes, ln_eps=spec.ln_eps,
                              use_norm=spec.use_norm)
        y = fused_cell.fused_cell_forward(serve, x, weights, ln)
        want = fused_cell.fused_cell_reference(serve, x, weights, ln)
        err = float((y - want).abs().max()) / float(want.abs().max())
        assert err <= TOL[torch.float32], (i, err)
        worst = max(worst, err)
    return checker, worst


def _p18_step(device, card):
    """Phase 18 (a), first part: one step of the recipe on its first train
    batch at seed 0's init, cuDNN deterministic.  #1/#2 on each cell's own
    tensors (:func:`_p18_kernels`), the backward also against float64;
    the step's gradients, kernels against plain versions, held per tensor
    to phase 8's rule on ``P17_NUDGES`` 1e-7 audio nudges of the kernels'
    step; a planted fault rejected."""
    from nbasr_torch.tools import quant_per_check
    loaders, trainer, model = quant_per_check.build(device, P18_SEEDS[0])
    calls = []
    with recipe_seeds.deterministic(), _recorded_cells(calls):
        recipe_seeds.step_gradients(trainer, model, next(iter(loaders[1])))
    checker, eval_err = _p18_kernels(calls)
    B, T = calls[0][1].shape[:2]
    print(f'phase 18 (a): #1 and #2 on the recipe\'s own tensors (the cells\' '
          f'inputs and output gradients of one step on its first batch, B={B},'
          f' T = {"/".join(str(c[1].shape[1]) for c in calls)}, C = '
          f'{"/".join(str(c[1].shape[2]) for c in calls)}, f32, dropout 0 and '
          f'{DROPOUT}) within their bounds, two calls bit-equal, gate flips '
          f'{checker.flips} of {checker.compared}; errors '
          f'{dict(checker.errors)}; the eval forward at {eval_err:.2e} of '
          f'scale [{card}]')
    w = recipe_seeds.step_witness(device, P18_SEEDS[0], P17_NUDGES,
                                  fault=planted_fault)
    bounds = kernel_grad_bounds(w['kernels nudged'])
    honest, at = over_bound(w['kernels vs plain'], bounds)
    planted, planted_at = over_bound(w['fault vs plain'], bounds)
    worst = lambda pair: max(w[pair].items(), key=lambda kv: kv[1])
    print(f'phase 18 (a): one step\'s gradients on that batch, kernels '
          f'against plain versions (cells and CTC), cuDNN deterministic: at '
          f'{honest:.3f} of their bound ({at}: {w["kernels vs plain"][at]:.3e}'
          f' against {bounds[at]:.3e}), bound min({KERNEL_GRAD_CAP:g}, max('
          f'{KERNEL_GRAD_TOL:g}, {KERNEL_GRAD_FACTOR:g} x the largest move '
          f'under {P17_NUDGES} 1e-7 audio nudges)); worst shares: kernels '
          f'vs plain %s %.3e, cell kernels only %s %.3e, CTC kernels only %s '
          f'%.3e, kernels nudged %s %.3e, plain nudged %s %.3e, plain on the '
          f'card vs the CPU %s %.3e; a planted fault (the last cell\'s first '
          f'bias gradient negated) at {planted:.1f} of its bound '
          f'({planted_at}): rejected [{card}]' % (
              *worst('kernels vs plain'), *worst('cell kernels vs plain'),
              *worst('ctc kernels vs plain'), *worst('kernels nudged'),
              *worst('plain nudged'), *worst('plain vs cpu')))
    f64 = {route: max(max(c[f'{route}_vs_f64'].values()) for c in w['cells'])
           for route in ('kernel', 'plain')}
    print(f'phase 18 (a): each cell backward of that step on its own tensors '
          f'against a float64 plain backward, dx over the live frames (the '
          f'utterances; {min(c["padded"] for c in w["cells"]):.0%} to '
          f'{max(c["padded"] for c in w["cells"]):.0%} of the frames are '
          f'padding, whose constant rows LayerNorm\'s backward scales by '
          f'1/sqrt(eps): max |dx| over all frames '
          f'{max(c["dx_max_over_live"] for c in w["cells"]):.0f} x the live '
          f'frames\' max) and dW: the kernels at worst {f64["kernel"]:.2e} of '
          f'a tensor\'s max, the plain versions {f64["plain"]:.2e} (tol '
          f'{GRAD_TOL[torch.float32]:.0e}) [{card}]')
    assert f64['kernel'] <= GRAD_TOL[torch.float32], f64
    assert honest <= 1.0, ('recipe step, kernels vs plain', at, honest)
    assert planted > 1.0, ('a planted fault passed', planted_at, planted)
    return dict(kernel_errors=dict(checker.errors), gate_flips=checker.flips,
                vs_f64=f64,
                eval_err=eval_err, over_bound=honest, at=at,
                planted=planted, worst={k: worst(k) for k in (
                    'kernels vs plain', 'kernels nudged', 'plain vs cpu')})


def _p18_recipe(device, card):
    """Phase 18 (a) and (b): :func:`_p18_step`, then quant_per_check's
    training from each of ``P18_SEEDS``, cuDNN deterministic, and int8 of
    each run's best weights; every run judged by the JAX test's three
    asserts, the gate on their majority (``P18_SEEDS`` says how)."""
    from nbasr_torch.tools import quant_per_check
    step = _p18_step(device, card)
    cells = sum(quant_per_check.RECIPE['cells_per_block'])
    epochs, runs, launches = quant_per_check.EPOCHS, {}, {}
    for seed in P18_SEEDS:
        loaders, trainer, model = quant_per_check.build(device, seed)
        steps, evals = loaders[1].steps, _batches(loaders[2])
        reset_launches()
        with recipe_seeds.deterministic():
            run = quant_per_check.train(trainer, model)
        launches[f'train_seed{seed}'] = launch_counts()
        assert launches[f'train_seed{seed}'] == expected_counts(
            device, steps=epochs * steps, evals=(epochs + 1) * evals,
            cells=cells), launches[f'train_seed{seed}']
        trainer.recall_best()
        reset_launches()
        q = quant_per_check.int8_check(trainer, loaders[3])
        launches[f'int8_seed{seed}'] = launch_counts()
        assert launches[f'int8_seed{seed}'] == expected_counts(
            device, forwards=2 * evals, evals=2 * evals, cells=cells), \
            launches[f'int8_seed{seed}']
        runs[seed] = dict(run, **q, passes=recipe_seeds.passes(run))
        curve = run['val_ler']
        dper = abs(q['int8']['ler'] - q['f32']['ler'])
        dloss = q['int8']['ctc_loss'] / q['f32']['ctc_loss'] - 1
        print(f'phase 18 (a) seed {seed}: the tone-corpus recipe (flagship '
              f'arch at 32/32/48/48, {cells} cells of 4 groups, no LSTM, B=8, '
              f'lr 1e-3, beam W=12) through #1-#4, {epochs} epochs: val LER '
              f'{[round(v, 3) for v in curve]}; best {run["best"]:.4f} at '
              f'epoch {run["best_epoch"]}, test on the best weights '
              f'{run["test"]["val_ler"]:.4f}, epoch 1 {curve[0]:.4f}: '
              f'{"passes" if runs[seed]["passes"] else "fails"}; '
              f'{np.median(run["epoch_seconds"]):.3f} s an epoch (median; '
              f'{steps} steps and {evals} eval batch); launches '
              f'{launches[f"train_seed{seed}"]} [{card}]')
        print(f'phase 18 (b) seed {seed}: int8 PTQ of the best weights: val '
              f'PER {q["int8"]["ler"]:.4f} against f32 {q["f32"]["ler"]:.4f} '
              f'(apart {dper:.4f}, tol {P18_INT8_PER_TOL}), CTC loss '
              f'{q["int8"]["ctc_loss"]:.4f} against {q["f32"]["ctc_loss"]:.4f} '
              f'({dloss:+.2%}, tol {P18_INT8_LOSS_TOL:.0%}); int8 logits '
              f'against f32 on trained weights: relative L2 '
              f'{q["rel_l2"]:.4e} (random init, phase 15\'s bound: '
              f'{INT8_SERVE_TOL}) [{card}]')
        assert abs(dloss) <= P18_INT8_LOSS_TOL, q
        runs[seed]['int8_per_ok'] = dper <= P18_INT8_PER_TOL
        del trainer, model
        gc.collect()
    passing = sum(r['passes'] for r in runs.values())
    int8_ok = sum(r['int8_per_ok'] for r in runs.values())
    median = lambda f: float(np.median([f(r) for r in runs.values()]))
    best, test = median(lambda r: r['best']), median(
        lambda r: r['test']['val_ler'])
    first = median(lambda r: r['val_ler'][0])
    print(f'phase 18 (a): over seeds {P18_SEEDS[0]}-{P18_SEEDS[-1]} the best '
          f'val LER ' + ', '.join(f'{r["best"]:.4f}' for r in runs.values())
          + f'; {passing} of {len(runs)} runs pass the JAX test\'s three '
          f'asserts (a majority needed); median best {best:.4f} (< '
          f'{P18_BEST_LER}), median test {test:.4f} (< {P18_TEST_LER}), '
          f'median epoch 1 {first:.4f} (> {P18_FIRST_LER}); int8 val PER '
          f'within {P18_INT8_PER_TOL} of f32\'s on {int8_ok} of {len(runs)} '
          f'runs (a majority needed), CTC loss within '
          f'{P18_INT8_LOSS_TOL:.0%} on every run [{card}]')
    assert 2 * passing > len(runs), {s: r['best'] for s, r in runs.items()}
    assert best < P18_BEST_LER and test < P18_TEST_LER, (best, test)
    assert first > P18_FIRST_LER, first
    assert 2 * int8_ok > len(runs), {s: (r['int8']['ler'], r['f32']['ler'])
                                     for s, r in runs.items()}
    return dict(runs=runs, passing=passing, int8_per_ok=int8_ok,
                median_best=best,
                median_test=test, median_first=first, step=step), launches


def _p18_flagship(device, card):
    """Phase 18 (c): the full-width flagship on per_run's recipe."""
    from nbasr_torch.tools import per_run
    loaders, trainer, model = per_run.build(device=device)
    trainer.verbose = False
    epochs, steps = P18_FLAGSHIP_EPOCHS, loaders[1].steps
    evals = _batches(loaders[2])
    reset_launches()
    t0 = time.perf_counter()
    history, test = trainer.train(model, epochs=epochs, lr=1e-3)
    run = per_run.summary(history, test, time.perf_counter() - t0)
    launches = launch_counts()
    loss = run['ctc_loss']
    print(f'phase 18 (c): the full-width flagship on per_run\'s recipe (bf16, '
          f'LSTM, dropout 0.2, B=16, 256 train and 32 val utterances, beam '
          f'W=12), {epochs} epochs: train CTC loss {[round(v, 4) for v in loss]}, '
          f'val LER {[round(v, 4) for v in run["val_ler"]]}, seconds an epoch '
          f'{[round(v, 3) for v in run["epoch_seconds"]]} ({steps} steps and '
          f'{evals} eval batches); launches {launches} [{card}]')
    assert launches == expected_counts(device, steps=epochs * steps,
                                       evals=(epochs + 1) * evals), launches
    assert all(np.isfinite(v) for v in loss + run['val_ctc_loss']), run
    assert loss[-1] < loss[0], loss
    return run, launches


def check_phase18(device):
    """Phase 18.  Returns (readings, launches by part)."""
    card = card_line()
    recipe, launches = _p18_recipe(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    flagship, launches['flagship'] = _p18_flagship(device, card)
    return dict(card=card, recipe=recipe, flagship=flagship), launches


# ---------------------------------------------------------------------------
# phase 19: the port's speed record, python -m nbasr_torch.bench
# ---------------------------------------------------------------------------

#: seconds the twin's process may take (30-90 s on an H100, kernels built)
P19_TIMEOUT_S = 400
#: the keys the twin adds to bench.py's (BENCH_r05.json's ``parsed``)
P19_NEW_KEYS = ('inference_latency_p90', 'inference_samples',
                'train_step_seconds_blocks', 'power_limit_w',
                'peak_memory_bytes', 'launches', 'train_step_kernel_seconds',
                'train_device_busy_share')
P19_SAMPLES = 100


def hold_bench_line(line, device, card, algo_tflops):
    """Phase 19's checks of the twin's last line: every key of
    ``BENCH_r05.json``'s result and the twin's own; every time, rate, share
    and memory figure finite and positive, with both FLOP counts; the card
    and its power limit; 18 fused forward launches per inference forward
    and 18 + 18 + 1 + 1 per train step, none plain; ``algorithmic_tflops``
    equal to ``algo_tflops``."""
    parsed = json.loads((REPO / 'BENCH_r05.json').read_text())['parsed']
    missing = (set(parsed) | set(P19_NEW_KEYS)) - set(line)
    assert not missing, missing
    assert line['device'] == torch.cuda.get_device_name(device), line['device']
    assert line['power_limit_w'] == power_limit_w(card), \
        (line['power_limit_w'], card)
    assert line['reduced'] is False and line['inference_samples'] == P19_SAMPLES
    positive = [line[k] for k in DEVICE_METRICS + ('train_step_tflops',
                                                   'algorithmic_tflops')
                if k != 'train_step_seconds_blocks']
    positive += line['train_step_seconds_blocks']
    assert len(line['train_step_seconds_blocks']) >= 3
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
               for v in positive), {k: line[k] for k in DEVICE_METRICS}
    assert line['launches'] == {
        'per_forward': expected_counts(device, forwards=1),
        'per_train_step': expected_counts(device, steps=1)}, line['launches']
    assert line['algorithmic_tflops'] == algo_tflops, \
        (line['algorithmic_tflops'], algo_tflops)


def check_phase19(device, bench_ms):
    """Phase 19: ``python -m nbasr_torch.bench`` in its own process on the
    card, its last line held by :func:`hold_bench_line`, its median forward
    beside phase 16's ``benchmark_pass`` median of the flagship
    (``bench_ms``, ms by arch hash).  Returns (its line, its launches a
    call)."""
    card = card_line()
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B, curriculum=())
    batch = next(iter(loaders[1]))
    flagship = get_model(FLAGSHIP, use_rnn=True, device='cpu')
    algo_tflops = algorithmic_flops(flagship, int(batch['audio'].shape[0]),
                                    int(batch['feature_size'].max())) / 1e12
    del flagship
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, '-m', 'nbasr_torch.bench'],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=P19_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = run.stdout.strip().splitlines()
    if run.returncode:
        print(run.stdout[-4000:], run.stderr[-4000:])
    assert run.returncode == 0, run.returncode
    for text in out[:-1]:
        print(f'  bench | {text}')
    line = json.loads(out[-1])
    hold_bench_line(line, device, card, algo_tflops)
    bench_pass_ms = bench_ms[search_space.get_model_hash(FLAGSHIP)]
    print(f'phase 19: python -m nbasr_torch.bench, exit 0 in {wall:.1f} s; '
          f'its line: {json.dumps(line)}')
    print(f'phase 19: the flagship f32 B=1, T=500 forward: the twin\'s median '
          f'{1e3 * line["inference_latency_median"]:.3f} ms ({P19_SAMPLES} '
          f'calls; min {1e3 * line["value"]:.3f}, p90 '
          f'{1e3 * line["inference_latency_p90"]:.3f}) beside phase 16\'s '
          f'benchmark_pass median {bench_pass_ms:.3f} ms ({BENCH_REPEATS} '
          f'calls); bf16 B={TRAIN_B} train step '
          f'{1e3 * line["train_step_seconds"]:.3f} ms, '
          f'{line["train_audio_seconds_per_sec_per_chip"]:.1f} audio-s/s, '
          f'busy {line["train_device_busy_share"]:.1%} [{card}]')
    return line, line['launches']


# ---------------------------------------------------------------------------
# phase 20: the LSTM recurrence (nbasr_torch/csrc/lstm.cu)
# ---------------------------------------------------------------------------
#
# FastLSTM(1200, 500), the flagship's head, at the main path's shapes: the
# recipe's bf16 train steps (B=64, T=75 and B=48, T=196, with and without an
# initial carry, forward and backward), serving (f32, B=64, T=60, the carry
# in and out, no grad), the proxies (B=1, T=32, with a backward, f32 and
# bf16) and an f32 train shape.  Each case runs the module three ways on the
# same inputs and weights: the kernels, their plain versions on the card
# (plain_lstm()), and a float64 copy of the module through the plain
# versions (its weights and inputs rounded to the case's dtype; xw in f32 as
# the module makes it, the recurrence in float64).  Every output and gradient reads as its largest
# gap from the float64 copy's over that tensor's largest value (a share).
# The kernels pass where each share is at most LSTM_FACTOR x the plain
# version's own or LSTM_FLOOR, whichever is larger: in f32 both differ from
# float64 by rounding alone (sum order, expf/tanhf against PyTorch's), far
# below the floor; in bf16 the loop rounds c and h after every elementwise
# op and the kernels once a frame, so both read about 1e-2 and the kernels
# no more than the loop.  A wrong index or a missed barrier reads about 1.
LSTM_F, LSTM_H = 1200, 500
LSTM_FACTOR = 2.0
LSTM_FLOOR = 1e-5
#: (label, dtype, B, T, initial carry, grad)
LSTM_CASES = (
    ('train B=64 T=75', torch.bfloat16, 64, 75, False, True),
    ('train B=64 T=75 carry', torch.bfloat16, 64, 75, True, True),
    ('train B=48 T=196', torch.bfloat16, 48, 196, False, True),
    ('train B=48 T=196 carry', torch.bfloat16, 48, 196, True, True),
    ('serve B=64 T=60 carry', torch.float32, 64, 60, True, False),
    ('proxy B=1 T=32', torch.float32, 1, 32, False, True),
    ('proxy B=1 T=32 bf16', torch.bfloat16, 1, 32, False, True),
    ('train f32 B=64 T=75 carry', torch.float32, 64, 75, True, True),
)
LSTM_KERNELS = ('nbasr_lstm_fwd', 'nbasr_lstm_bwd')


def _lstm_operands(dtype, B, T, carry, device, seed):
    gen = torch.Generator().manual_seed(seed)
    m = FastLSTM(LSTM_F, LSTM_H, compute_dtype=dtype, generator=gen)
    x = torch.randn(B, T, LSTM_F, generator=gen)
    init = tuple(0.5 * torch.randn(B, LSTM_H, generator=gen)
                 for _ in range(2)) if carry else None
    w = [torch.randn(B, T, LSTM_H, generator=gen),
         torch.randn(B, LSTM_H, generator=gen),
         torch.randn(B, LSTM_H, generator=gen)]
    ref = FastLSTM(LSTM_F, LSTM_H, compute_dtype=torch.float64)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.copy_(getattr(m, name).to(dtype).double())
    return (m.to(device), x.to(device),
            None if init is None else tuple(v.to(device) for v in init),
            [v.to(device) for v in w],
            ref.to(device), x.to(dtype).double().to(device),
            None if init is None else tuple(
                v.to(dtype).double().to(device) for v in init))


def _lstm_run(m, x, init, w, grad):
    """{name: tensor} of the outputs and, with grad, the gradients of
    sum(w * (out, c, h)) with respect to the input, the weights and the
    initial carry."""
    with torch.set_grad_enabled(grad):
        xin = x.detach().requires_grad_(grad)
        carry = None if init is None else tuple(
            v.detach().requires_grad_(grad) for v in init)
        out, (c, h) = m(xin, carry, return_carry=True)
        got = {'out': out, 'c': c, 'h': h}
        if grad:
            loss = sum((o.to(wi.dtype) * wi).sum()
                       for o, wi in zip((out, c, h), w))
            leaves = [xin, m.kernel, m.recurrent, m.bias, *(carry or ())]
            names = ['dx', 'dkernel', 'drecurrent', 'dbias'] + (
                ['dc0', 'dh0'] if carry else [])
            got.update(zip(names, torch.autograd.grad(loss, leaves)))
    return {k: v.detach() for k, v in got.items()}


def _lstm_shares(got, ref):
    return {k: float((got[k].double() - ref[k]).abs().max()
                     / ref[k].abs().max().clamp_min(1e-30)) for k in ref}


def _lstm_profile(fn):
    """(kernels launched, their device ms, device ms of each LSTM kernel)
    of one call of ``fn``, by torch.profiler; None where it saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        return None
    own = {k: 1e3 * device_seconds([e for e in kernels if k in e.key])
           for k in LSTM_KERNELS}
    return sum(e.count for e in kernels), 1e3 * device_seconds(kernels), own


def check_lstm(device):
    """Phase 20: the LSTM recurrence kernels against their plain versions
    and a float64 copy at the main path's shapes, two calls bit-equal, their
    launches and timings beside the plain loop's, and the flagship's train
    and serving forwards through them.  Returns the rows of the cases."""
    card = card_line()
    from nbasr_torch.ops import lstm_recurrence
    from nbasr_torch.ops.plain import plain_lstm
    rows, bad = [], []
    for i, (label, dtype, B, T, carry, grad) in enumerate(LSTM_CASES):
        m, x, init, w, ref_m, x64, init64 = _lstm_operands(
            dtype, B, T, carry, device, seed=SEED + i)
        w64 = [v.double() for v in w]
        lstm_recurrence.reset_launches()
        got = _lstm_run(m, x, init, w, grad)
        counts = {k: dict(v) for k, v in lstm_recurrence.LAUNCHES.items()}
        want = {'forward': {'kernel': 1, 'plain': 0},
                'backward': {'kernel': int(grad), 'plain': 0}}
        assert counts == want, (label, counts)
        again = _lstm_run(m, x, init, w, grad)
        bit_equal = all(torch.equal(got[k], again[k]) for k in got)
        with plain_lstm():
            plain = _lstm_run(m, x, init, w, grad)
        with plain_lstm():                  # the kernels take f32 and bf16
            ref = _lstm_run(ref_m, x64, init64, w64, grad)
        kernel_share = _lstm_shares(got, ref)
        plain_share = _lstm_shares(plain, ref)
        vs_plain = _lstm_shares(got, {k: v.double() for k, v in plain.items()})
        limit = {k: max(LSTM_FACTOR * plain_share[k], LSTM_FLOOR)
                 for k in ref}
        over = {k: (kernel_share[k], limit[k]) for k in ref
                if not kernel_share[k] <= limit[k]}
        call = functools.partial(_lstm_run, m, x, init, w, grad)
        ms = time_ms(call, runs=20, warmup=3)
        with plain_lstm():
            plain_ms = time_ms(call, runs=3, warmup=1)
        prof = _lstm_profile(call)
        with plain_lstm():
            plain_prof = _lstm_profile(call)
        row = dict(case=label, dtype=str(dtype)[6:], B=B, T=T, carry=carry,
                   grad=grad, bit_equal_calls=bit_equal, launches=counts,
                   kernel_share=kernel_share, plain_share=plain_share,
                   kernel_vs_plain_share=vs_plain, limit=limit, over=over,
                   ms=ms, plain_ms=plain_ms,
                   kernels_per_call=prof and prof[0],
                   device_ms=prof and prof[1],
                   lstm_kernel_device_ms=prof and prof[2],
                   plain_kernels_per_call=plain_prof and plain_prof[0],
                   plain_device_ms=plain_prof and plain_prof[1])
        rows.append(row)
        print(f'phase 20 {label}: shares of the float64 copy (kernels / '
              f'plain / limit) ' + ', '.join(
                  f'{k} {kernel_share[k]:.2e}/{plain_share[k]:.2e}/'
                  f'{limit[k]:.2e}' for k in ref)
              + f'; kernels vs plain max {max(vs_plain.values()):.2e}; '
              f'bit-equal calls {bit_equal}; {ms:.3f} ms a call on events '
              f'({plain_ms:.3f} plain), device '
              + ('not measured' if prof is None else
                 f'{prof[1]:.3f} ms in {prof[0]} kernels ('
                 + ', '.join(f'{k} {v:.3f} ms' for k, v in prof[2].items())
                 + ')')
              + ('' if plain_prof is None else
                 f', plain {plain_prof[1]:.3f} ms in {plain_prof[0]} '
                 f'kernels'))
        if over or not bit_equal:
            bad.append((label, over, bit_equal))
        del m, x, init, w, ref_m, x64, init64, got, again, plain, ref
        torch.cuda.empty_cache()
    # the main path: the flagship's bf16 train forward and backward, and
    # its f32 serving head with the carry, through the kernels
    model = get_model(FLAGSHIP, compute_dtype=torch.bfloat16, device=device)
    feats = torch.randn(4, 300, 80, device=device)
    lstm_recurrence.reset_launches()
    model.train()
    model(feats, generator=torch.Generator().manual_seed(SEED)).float() \
        .square().sum().backward()
    train_counts = {k: dict(v) for k, v in lstm_recurrence.LAUNCHES.items()}
    serve_model = get_model(FLAGSHIP, device=device).eval()
    lstm_recurrence.reset_launches()
    with torch.no_grad():
        enc = serve_model(feats, stage='encode')
        carry = None
        for piece in enc.split(25, dim=1):
            _, carry = serve_model(piece, stage='head', rnn_carry=carry,
                                   return_rnn_carry=True)
    serve_counts = {k: dict(v) for k, v in lstm_recurrence.LAUNCHES.items()}
    pieces = len(enc.split(25, dim=1))
    print(f'phase 20: the flagship through the LSTM kernels: a bf16 train '
          f'forward and backward {train_counts}, {pieces} f32 serving head '
          f'calls with the carry {serve_counts} [{card}]')
    assert train_counts == {'forward': {'kernel': 1, 'plain': 0},
                            'backward': {'kernel': 1, 'plain': 0}}, train_counts
    assert serve_counts == {'forward': {'kernel': pieces, 'plain': 0},
                            'backward': {'kernel': 0, 'plain': 0}}, serve_counts
    assert not bad, bad
    return rows, {'train_step': train_counts, 'serving': serve_counts}


#: (label, dtype, B, T, H, D) of phase 21's attention cases: small ones
#: with odd T and padded rows, then the conformer-l.train cell's buckets
RELPOS_CASES = [('f32 B=3 T=67', torch.float32, 3, 67, 2, 64),
                ('bf16 B=3 T=130', torch.bfloat16, 3, 130, 2, 64),
                ('bf16 short bucket', torch.bfloat16, 64, 399, 8, 64),
                ('bf16 long bucket', torch.bfloat16, 32, 875, 8, 64)]
#: a kernel output's widest gap from the plain version's, over the plain
#: version's largest value: f32 sums in another order; bf16 rounds the
#: softmax weights and dS to bf16 before their products (2^-8 relative)
RELPOS_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: phase 21's Conformer (L) train step: the long bucket of
#: ``conformer-l.train`` (T' = 875 after the subsampling)
CONFORMER_STEP = dict(batch=32, frames=3504, labels=400)


def _relpos_operands(dtype, B, T, H, D, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)
    q, k, v = (draw(B, T, H, D) for _ in range(3))
    r = draw(2 * T - 1, H, D)
    u, vb = (torch.randn((H, D), generator=g, device=device) * 0.1
             for _ in range(2))
    lengths = torch.randint(max(T // 4, 1), T + 1, (B,), generator=g,
                            device=device, dtype=torch.int32)
    lengths[0] = T
    lengths[-1] = max(T // 2 - 1, 1)
    return [q, k, v, r, u, vb], lengths


def _relpos_counts(B, T, H, D, lengths, esize, backward):
    """(operations, bytes) as perfbench's ``attention_counts``."""
    sq = float(sum(L * L for L in lengths))
    act = float(sum(lengths)) * H * D * esize
    band = (2 * max(lengths) - 1) * H * D * esize
    lse = float(sum(lengths)) * H * 4
    if backward:
        return 10.0 * H * D * sq, 8 * act + 2 * band + 4 * H * D * 4 + lse
    return 6.0 * H * D * sq, 4 * act + band + 2 * H * D * 4 + 4 * B + lse


def _share(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def check_relpos(device):
    """Phase 21: the hash dropout and the relative-position attention
    kernels against their plain versions on the card, the memory an
    attention call adds, and their times.  Returns the kernels' entry."""
    import triton
    from nbasr_torch.ops import hash_dropout, relpos_attention as ra
    from nbasr_torch.ops.plain import plain_attention, plain_dropout
    print(f'phase 21: triton {triton.__version__} (the dropout), torch '
          f'{torch.__version__}')
    drop_rows = []
    for shape, dtype in (((3, 37, 100), torch.float32),
                         ((64, 399, 2048), torch.bfloat16)):
        x = torch.randn(shape, device=device).to(dtype).requires_grad_(True)
        hash_dropout.reset_launches()
        y = hash_dropout.hash_dropout(x, (123456789, 2 ** 31 - 2), 5, 0.1)
        gy = torch.randn_like(y)
        (gx,) = torch.autograd.grad(y, x, gy)
        with plain_dropout():
            yp = hash_dropout.hash_dropout(x, (123456789, 2 ** 31 - 2), 5,
                                           0.1)
            (gxp,) = torch.autograd.grad(yp, x, gy)
        launches = dict(hash_dropout.LAUNCHES)
        assert torch.equal(y, yp) and torch.equal(gx, gxp), shape
        assert launches == {'kernel': 2, 'plain': 2}, launches
        kept = float((y != 0).float().mean())
        ms = time_ms(lambda: hash_dropout.hash_dropout(
            x.detach(), (1, 2), 3, 0.1), runs=20, warmup=3)
        bound = 2 * x.numel() * x.element_size() / 3.35e12 * 1e3
        drop_rows.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                              bit_equal=True, kept=kept, ms=ms,
                              bound_ms=bound))
        print(f'phase 21 dropout {shape} {dtype}: bit-equal to plain '
              f'forward and backward, kept {kept:.4f}, {ms:.3f} ms '
              f'(bound {bound:.3f})')
    rows = []
    for i, (label, dtype, B, T, H, D) in enumerate(RELPOS_CASES):
        ops, lengths = _relpos_operands(dtype, B, T, H, D, device, SEED + i)
        leaves = [t.requires_grad_(True) for t in ops]
        ra.reset_launches()
        out = ra.relpos_attention(*leaves, lengths)
        dout = torch.randn_like(out)
        grads = torch.autograd.grad(out, leaves, dout)
        counts = {k: dict(v) for k, v in ra.LAUNCHES.items()}
        assert counts == {'forward': {'kernel': 1, 'plain': 0},
                          'backward': {'kernel': 1, 'plain': 0}}, counts
        with plain_attention():
            p_out = ra.relpos_attention(*leaves, lengths)
            p_grads = torch.autograd.grad(p_out, leaves, dout)
        names = ('out', 'dq', 'dk', 'dv', 'dr', 'du', 'dv_bias')
        shares = dict(zip(names, [_share(a, b) for a, b in zip(
            (out,) + grads, (p_out,) + p_grads)]))
        pad = (torch.arange(T, device=device)[None, :]
               >= lengths[:, None].long())
        padded_zero = bool((out.detach()[pad] == 0).all()
                           and (grads[0][pad] == 0).all())
        limit = RELPOS_LIMIT[dtype]
        over = {k: v for k, v in shares.items() if not v <= limit}
        # the memory a call adds: its outputs and log-sum-exp, no T x T
        x = [t.detach() for t in leaves]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o, lse = ra._launch_forward(*x, lengths)
        torch.cuda.synchronize()
        fwd_added = torch.cuda.max_memory_allocated() - base
        fwd_allowed = o.nbytes + lse.nbytes + (1 << 20)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        g = ra._launch_backward(*x, lengths, o, lse, dout)
        torch.cuda.synchronize()
        bwd_added = torch.cuda.max_memory_allocated() - base
        bwd_allowed = (sum(t.nbytes for t in g) + lse.nbytes
                       + H * (2 * T - 1) * D * 4 + 2 * H * D * 4 + (1 << 20))
        scores = B * H * T * T * 4
        del g
        assert fwd_added <= fwd_allowed and bwd_added <= bwd_allowed, (
            label, fwd_added, fwd_allowed, bwd_added, bwd_allowed)
        fwd = functools.partial(ra._launch_forward, *x, lengths)
        bwd = functools.partial(ra._launch_backward, *x, lengths, o, lse,
                                dout)
        ms = time_ms(fwd, runs=10, warmup=2)
        bms = time_ms(bwd, runs=10, warmup=2)
        dev_ms, dev_bms = device_ms(fwd, runs=10), device_ms(bwd, runs=10)
        with plain_attention():
            plain_ms = time_ms(lambda: ra._launch_forward(*x, lengths),
                               runs=2, warmup=1)
            plain_bms = time_ms(lambda: ra._launch_backward(
                *x, lengths, o, lse, dout), runs=2, warmup=1)
        L = [int(v) for v in lengths.tolist()]
        es = torch.finfo(dtype).bits // 8
        peak = 989e12 if es == 2 else 67e12
        bounds = [max(c[0] / peak, c[1] / 3.35e12) * 1e3 for c in (
            _relpos_counts(B, T, H, D, L, es, False),
            _relpos_counts(B, T, H, D, L, es, True))]
        row = dict(case=label, dtype=str(dtype)[6:], B=B, T=T, H=H, D=D,
                   lengths_sum=sum(L), shares=shares, limit=limit,
                   padded_rows_zero=padded_zero, fwd_added_bytes=fwd_added,
                   fwd_allowed_bytes=fwd_allowed, bwd_added_bytes=bwd_added,
                   bwd_allowed_bytes=bwd_allowed, scores_bytes=scores,
                   ms=ms, bwd_ms=bms, device_ms=dev_ms, bwd_device_ms=dev_bms,
                   plain_ms=plain_ms, plain_bwd_ms=plain_bms,
                   bound_ms=bounds[0], bwd_bound_ms=bounds[1],
                   roofline=100 * bounds[0] / dev_ms,
                   bwd_roofline=100 * bounds[1] / dev_bms)
        rows.append(row)
        print(f'phase 21 {label}: shares of the plain version '
              + ', '.join(f'{k} {v:.2e}' for k, v in shares.items())
              + f' (limit {limit:.0e}); padded rows zero {padded_zero}; '
              f'added MB fwd {fwd_added / 2**20:.1f} (allowed '
              f'{fwd_allowed / 2**20:.1f}), bwd {bwd_added / 2**20:.1f} '
              f'({bwd_allowed / 2**20:.1f}); a T x T f32 score tensor '
              f'{scores / 2**20:.1f} MB; fwd {ms:.3f} ms events, '
              f'{dev_ms:.3f} device, bound {bounds[0]:.3f}, plain '
              f'{plain_ms:.3f}; bwd {bms:.3f} ms events, {dev_bms:.3f} '
              f'device, bound {bounds[1]:.3f}, plain {plain_bms:.3f}')
        assert not over and padded_zero, (label, over)
    step = check_conformer_step(device)
    return dict(name='relpos_attention', route='cuda',
                source='nbasr_torch/csrc/relpos_attention.cu', replaces=None,
                kernels=list(ra.KERNELS), per_case=rows, train_step=step,
                dropout=dict(kernel=_build.TRITON_KERNELS[0],
                             source='nbasr_torch/ops/hash_dropout.py',
                             per_case=drop_rows))


def check_conformer_step(device):
    """Phase 21's last check: one bf16 Conformer (L) ``Trainer.step`` at
    ``CONFORMER_STEP``'s shape, with the attention's and the dropout's
    launch counters reset just before it: 17 forward and 17 backward
    attention calls on the kernels (one a block), 206 dropout calls (six
    sites a block and the subsampling's one, each way), none plain."""
    from nbasr_torch.models.conformer import get_conformer
    from nbasr_torch.ops import hash_dropout, relpos_attention as ra
    from nbasr_torch.training import Trainer
    B, frames, n_labels = (CONFORMER_STEP[k]
                           for k in ('batch', 'frames', 'labels'))
    g = torch.Generator().manual_seed(SEED)
    model = get_conformer(compute_dtype=torch.bfloat16, device=device,
                          generator=g)
    sizes = np.linspace(frames, frames // 2, B).astype(np.int32)
    label_size = (sizes * n_labels // frames).astype(np.int32)
    labels = torch.randint(1, 49, (B, n_labels), generator=g,
                           dtype=torch.int32).numpy()
    labels[np.arange(n_labels)[None, :] >= label_size[:, None]] = 0
    batch = {'audio': (torch.randn(B, 400 + (frames - 1) * 160, generator=g)
                       * 0.1).numpy(),
             'feature_size': sizes, 'labels': labels,
             'label_size': label_size, 'valid': np.ones(B, np.float32)}
    trainer = Trainer((None, None, None, None), device=device, verbose=False,
                      tensorboard=False)
    trainer.init_state(model, seed=SEED)
    torch.cuda.synchronize()
    ra.reset_launches()
    hash_dropout.reset_launches()
    t = time.perf_counter()
    loss = trainer.step(batch, lr=1e-4)['ctc_loss']
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    attention = {k: dict(v) for k, v in ra.LAUNCHES.items()}
    dropout = dict(hash_dropout.LAUNCHES)
    print(f'phase 21 Conformer (L) bf16 train step B={B} x {frames} frames: '
          f'attention {attention}, dropout {dropout}, loss {loss:.4f}, '
          f'{seconds:.2f} s (the first step)')
    assert attention == {'forward': {'kernel': 17, 'plain': 0},
                         'backward': {'kernel': 17, 'plain': 0}}, attention
    assert dropout == {'kernel': 206, 'plain': 0}, dropout
    assert math.isfinite(loss) and trainer.nonfinite_steps == 0, loss
    return dict(batch=B, frames=frames, attention=attention, dropout=dropout,
                loss=loss, first_step_s=seconds)


# phase 22: the linear node's three products on the tensor cores
# (csrc/linear_mma.cuh) at the shapes the recipe gives them: timit-recipe's
# two buckets (B=64 x 300 and B=48 x 784 frames) and the zero-cost
# proxies' B=1 x 128, at each block's width, T halved by the stride-2
# blocks 3 and 4; linear-dilated's linear node (node 0, a skip from the
# cell input), dropout 0.2.
LINEAR_SHAPES = (('short', 64, 300), ('long', 48, 784), ('proxy', 1, NAS_FRAMES))
LINEAR_T_DIV = (1, 1, 2, 4)
# (product, the kernels' names it covers): the forward, dx, and dW with
# its ordered reduce of the row chunks
LINEAR_PRODUCTS = (('fwd', 'nbasr_linear_node'), ('dx', 'nbasr_linear_dx'),
                   ('dw', 'nbasr_linear_dw'))
LINEAR_PROFILED_CALLS = 5
# Kernels against the plain versions on the card, as a share of max|plain|:
# both sum the bf16 products in f32, in other orders, over C terms (dW over
# B*T rows), and round at the same points, so a value moves by one bf16 ulp
# (2^-8 of itself) where the two sums straddle a rounding boundary: phase
# 6's bf16 bound.
LINEAR_TOL = GRAD_TOL[torch.bfloat16]


def _linear_operands(B, T, C, dtype, device):
    g = torch.Generator().manual_seed(SEED + B * T + C)
    x = torch.randn((B, T, C), generator=g).to(device, dtype)
    dy = torch.randn((B, T, C), generator=g).to(device, dtype)
    w = (torch.randn((C, C), generator=g) / C ** 0.5).to(device, dtype)
    b = (0.1 * torch.randn((C,), generator=g)).to(device)
    return x, dy, [w, b]


def _linear_kernel_us(run, calls=LINEAR_PROFILED_CALLS):
    """(device us a call of each product's kernels, by name, over ``calls``
    forward and backward calls; the kernels' names), None where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        return None, []
    names = [e.key for e in kernels if 'nbasr_linear' in e.key]
    return {k: sum(e.self_device_time_total for e in kernels if name in e.key)
            / calls for k, name in LINEAR_PRODUCTS}, names


def check_linear(device):
    """Phase 22: the linear node's tensor-core kernels against their plain
    versions on the card at LINEAR_SHAPES (outputs, multipliers, dx, dW,
    db; the backward bit-equal across two calls; the tracing counters),
    each product's device time, TFLOP/s and share of the bf16 peak beside
    torch.matmul's time at the same shapes (a yardstick only); then an f32
    cell, which must run the SIMT kernels.  Returns the kernels' entry."""
    from nbasr_torch.utils import tracing
    spec = FusedCellSpec([fused_cell.LinearNode((0,))], dropout_rate=DROPOUT,
                         train=True, use_norm=False)
    seed = torch.tensor(TRAIN_SEED, dtype=torch.int32, device=device)
    rows = []
    for label, B, T in LINEAR_SHAPES:
        for (C, _), div in zip(TRAIN_WIDTHS, LINEAR_T_DIV):
            Tb = T // div
            x, dy, weights = _linear_operands(B, Tb, C, torch.bfloat16, device)
            fused_cell.reset_launches()
            tracing.reset()
            with tracing.enabled():
                y, outs, mults = fused_cell.fused_cell_train_forward(
                    spec, x, weights, None, seed)
                dx, dws, _ = fused_cell.fused_cell_backward(
                    spec, x, outs, mults, dy, weights, None)
                counts = dict(tracing.snapshot()['counts'])
            dx2, dws2, _ = fused_cell.fused_cell_backward(
                spec, x, outs, mults, dy, weights, None)
            launches = (dict(fused_cell.LAUNCHES),
                        dict(fused_cell.BACKWARD_LAUNCHES))
            same = torch.equal(dx, dx2) and all(
                torch.equal(a, b) for a, b in zip(dws, dws2))
            py, _, pmults = fused_cell.fused_cell_reference(
                spec, x, weights, None, seed, save=True)
            pdx, pdws, _ = fused_cell.fused_cell_backward_reference(
                spec, x, outs, mults, dy, weights, None)
            shares = {'y': _share(y, py), 'dx': _share(dx, pdx),
                      'dw': _share(dws[0], pdws[0]),
                      'db': _share(dws[1], pdws[1])}
            flips = float((mults != pmults).float().mean())

            def run():
                _, o, m = fused_cell.fused_cell_train_forward(
                    spec, x, weights, None, seed)
                fused_cell.fused_cell_backward(spec, x, o, m, dy, weights,
                                               None)
            us, names = _linear_kernel_us(run)
            a, d, w = x.reshape(-1, C), dy.reshape(-1, C), weights[0]
            library = {k: time_ms(f, runs=10, warmup=2) for k, f in (
                ('fwd', lambda: torch.matmul(a, w)),
                ('dx', lambda: torch.matmul(d, w.T)),
                ('dw', lambda: torch.matmul(a.T, d)))}
            ops = 2 * B * Tb * C * C
            products = {k: dict(
                device_us=None if us is None else us[k],
                tflops=None if us is None else ops / us[k] / 1e6,
                peak_share=None if us is None
                else 100 * ops / us[k] / 1e6 / 989, library_ms=library[k])
                for k, _ in LINEAR_PRODUCTS}
            row = dict(shape=label, B=B, T=Tb, C=C, rows=B * Tb,
                       shares=shares, gate_flip_share=flips,
                       bit_equal_backward=same, counters=counts,
                       launches=launches, products=products,
                       dw_chunks=fused_cell.dw_chunks(
                           B * Tb, C, grouped_conv._sm_count(device)),
                       kernels=sorted({n[:60] for n in names}))
            rows.append(row)
            print(f'phase 22 {label} B={B} T={Tb} C={C}: shares '
                  + ', '.join(f'{k} {v:.2e}' for k, v in shares.items())
                  + f' (limit {LINEAR_TOL:.0e}), gate flips {flips:.1e}, '
                  f'backward bit-equal {same}, counters {counts}; '
                  + '; '.join(
                      f'{k} {p["device_us"]:.1f} us {p["tflops"]:.1f} TFLOP/s '
                      f'({p["peak_share"]:.1f}% of bf16 peak), matmul '
                      f'{1e3 * p["library_ms"]:.1f} us'
                      if p['device_us'] is not None else f'{k} not measured'
                      for k, p in products.items()), flush=True)
            assert all(v <= LINEAR_TOL for v in shares.values()), shares
            assert flips <= GATE_FLIP_SHARE and same, (flips, same)
            assert counts == {'cell.linear_mma': 2}, counts
            assert launches == ({'kernel': 1, 'plain': 0},
                                {'kernel': 2, 'plain': 0}), launches
            assert not names or all('_mma' in n or 'reduce' in n
                                    for n in names), names
    # f32 keeps the SIMT kernels, exact f32 on FMAs
    x, dy, weights = _linear_operands(CHECK_B, 300, 600, torch.float32, device)
    tracing.reset()

    def run32():
        _, o, m = fused_cell.fused_cell_train_forward(spec, x, weights, None,
                                                      seed)
        fused_cell.fused_cell_backward(spec, x, o, m, dy, weights, None)
    with tracing.enabled():
        run32()
        counts32 = dict(tracing.snapshot()['counts'])
    _, names32 = _linear_kernel_us(run32, calls=1)
    print(f'phase 22 f32 B={CHECK_B} T=300 C=600: counters {counts32}, '
          f'kernels {sorted({n[:60] for n in names32})}')
    assert counts32 == {'cell.linear_fma': 2}, counts32
    assert not names32 or all('_mma' not in n and 'float' in n
                              for n in names32), names32
    return dict(name='linear_mma', route='cuda',
                source='nbasr_torch/csrc/linear_mma.cuh',
                replaces='nbasr_tpu/ops/fused_cell.py _emit_linear',
                tolerance=LINEAR_TOL, per_shape=rows,
                f32=dict(counters=counts32, kernels=names32))


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device')
    device = torch.device('cuda')
    torch.backends.cudnn.allow_tf32 = False       # f32 means f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f'card: {card} ({torch.cuda.get_device_name(0)})')
    t0 = time.perf_counter()
    built = _build.build()
    print(f'build: {time.perf_counter() - t0:.1f} s')
    for name, (path, log) in built.items():
        print(f'  {name}: {path}')
        for line in log.splitlines():
            if ('registers' in line or 'spill' in line or 'Compiling' in line
                    or line.startswith('compiled in')):
                print('   ', line.strip())

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f'[{label}: {time.perf_counter() - t:.1f} s, '
              f'{time.perf_counter() - t0:.1f} s since the build began]')
        return out

    errors, rows, fwd_nonfinite = timed('phase 3', check_kernels, device)
    launches, serving = timed('phases 4-5', check_serving, device)
    checker, kept, train_rows, bwd_nonfinite, train_fwd_nonfinite = timed(
        'phase 6', check_train_kernels, device)
    train_errors = checker.errors
    at_step = {k: {str(d)[6:]: v[1] for d, v in e.items()}
               for k, e in checker.step_errors.items()}
    fused_launches, train = timed('phase 7', check_train_step, device)
    fwd_train = fused_launches['fused_forward']
    bwd_train = fused_launches['fused_backward']
    train_grads = timed('phase 8', check_train_cpu, device)
    gconv_errors, gconv_rows, nonfinite = timed('phase 9', check_gconv_kernels,
                                                device)
    grouped_logits, model_options = timed('phase 10', check_grouped_forward,
                                          device)
    grouped_train = {impl: timed(f'phase 11 {impl}', check_train_step, device,
                                 impl) for impl in ('pallas', 'pallas_split')}
    grouped_grads = timed('phase 11 gradients', check_grouped_grads, device)
    ctc_errors, ctc_rows, ctc_readings = timed('phase 12', check_ctc_kernels,
                                               device)
    eval_alpha, evaluation = timed('phase 13', check_eval, device)
    nas_rows, nas_counts, nas_search = timed('phase 14', check_nas, device)
    p15, p15_launches = timed('phase 15', check_phase15, device)
    p16, p16_launches = timed('phase 16', check_phase16, device)
    p17, p17_launches = timed('phase 17', check_phase17, device)
    p18, p18_launches = timed('phase 18', check_phase18, device)
    gc.collect()
    torch.cuda.empty_cache()        # the twin's process gets the card
    bench_line, p19_launches = timed('phase 19', check_phase19, device,
                                     p16['static']['bench_ms'])
    lstm_rows, lstm_launches = timed('phase 20', check_lstm, device)
    relpos = timed('phase 21', check_relpos, device)
    linear = timed('phase 22', check_linear, device)

    # one serving step's 18 f32 cells, from the per-width timings
    f32_rows = [r for r in rows if r['dtype'] == 'float32']
    step = train_step_sums(f32_rows, ('ms', 'device_ms', 'plain_ms',
                                      'bound_ms'))
    # one train step's 18 bf16 cells
    bf16_rows = [r for r in train_rows if r['dtype'] == 'bfloat16']
    tstep = train_step_sums(bf16_rows, (
        'ms', 'device_ms', 'plain_ms', 'bound_ms', 'fwd_ms', 'fwd_device_ms',
        'fwd_plain_ms', 'fwd_bound_ms'))
    kernels = [dict(
        name='fused_cell_forward', route='cuda',
        source='nbasr_torch/csrc/fused_cell.cu',
        replaces='nbasr_tpu/ops/fused_cell.py:388',
        launches=launches, max_abs_err=errors[torch.float32],
        ms=step['ms'], plain_ms=step['plain_ms'], bound_ms=step['bound_ms'],
        bound_by='bytes' if all(r['bound_by'] == 'bytes' for r in f32_rows)
        else 'operations',
        library_ms=None,
        max_abs_err_bf16=errors[torch.bfloat16],
        times_cover='the 18 f32 cells of one flagship serving step, B=4, '
                    'T=772/772/386/193',
        device_ms=step['device_ms'],
        device_times_cover='the same cells, device time per call of 20 '
                           'calls queued back to back behind a spin kernel '
                           '(no wrapper host time)',
        kernels=FWD_KERNELS[:4],
        launches_per_cell=train['fwd_kernels_per_cell'],
        bit_equal_calls=True,
        nonfinite_outputs_checked={'serving': fwd_nonfinite,
                                   'train': train_fwd_nonfinite},
        per_width=rows,
        dropout_checked=True, dropout_gate_flips=checker.flips,
        dropout_multipliers_compared=checker.compared, dropout_kept_share=kept,
        train_max_abs_err=train_errors['forward'][torch.float32][0],
        train_max_abs_err_bf16=train_errors['forward'][torch.bfloat16][0],
        launches_train_step=fwd_train,
        train_ms=tstep['fwd_ms'], train_plain_ms=tstep['fwd_plain_ms'],
        train_bound_ms=tstep['fwd_bound_ms'],
        train_device_ms=tstep['fwd_device_ms'],
        train_times_cover='the 18 bf16 training forwards (dropout 0.2, '
                          'saving) of one flagship train step, B=32, '
                          'T=300/300/150/75',
        train_checked_at=TRAIN_CHECKED_AT,
        train_step_shape_max_share_err=at_step['forward']),
        dict(
        name='fused_cell_backward', route='cuda',
        source='nbasr_torch/csrc/fused_cell_bwd.cu',
        replaces='nbasr_tpu/ops/fused_cell.py:447',
        launches=bwd_train,
        max_abs_err=train_errors['backward'][torch.float32][0],
        ms=tstep['ms'], plain_ms=tstep['plain_ms'], bound_ms=tstep['bound_ms'],
        bound_by='bytes' if all(r['bound_by'] == 'bytes' for r in bf16_rows)
        else 'operations',
        library_ms=None,
        max_share_err=train_errors['backward'][torch.float32][1],
        max_abs_err_bf16=train_errors['backward'][torch.bfloat16][0],
        max_share_err_bf16=train_errors['backward'][torch.bfloat16][1],
        times_cover='the 18 bf16 cells of one flagship train step, B=32, '
                    'T=300/300/150/75',
        device_ms=tstep['device_ms'],
        device_times_cover='the same cells, device time per call of 20 '
                           'calls queued back to back behind a spin kernel '
                           '(no wrapper host time)',
        kernels=BWD_KERNELS,
        nonfinite_outputs_checked=bwd_nonfinite,
        checked_at=TRAIN_CHECKED_AT + '; ' + BWD_NONFINITE_AT,
        train_step_shape_max_share_err=at_step['backward'],
        step_gradient_worst_share=train_grads,
        per_width=train_rows),
    ]
    kernels += [gconv_entry(name, gconv_errors, gconv_rows, grouped_train,
                            grouped_logits, grouped_grads, nonfinite)
                for name in GCONV_KERNELS]
    all_train = {'auto': (fused_launches, train), **grouped_train}
    kernels += [ctc_entry(name, ctc_errors, ctc_rows, ctc_readings, all_train,
                          eval_alpha) for name in ('alpha', 'beta')]
    # phase 14's main path: 12 compute_proxy calls, the synflow and
    # grad_norm proxy searches and CLI calls; no other kernel runs there
    proxy_path = dict(zip(('fused_cell_forward', 'fused_cell_backward',
                           'ctc_alpha', 'ctc_beta'), nas_counts))
    for entry in kernels:
        if entry['name'] in proxy_path:
            entry['launches_proxy_path'] = proxy_path[entry['name']]['kernel']
    # phase 15's paths: the step resumed from a flax checkpoint, int8
    # serving (f32), and the remat_cells step
    resumed = p15_launches['resumed']
    remat_fwd, remat_bwd = p15_launches['remat']
    phase15 = {
        'fused_cell_forward': dict(
            resumed_step=resumed['fused_forward']['kernel'],
            int8_serving=p15_launches['int8_forward'],
            remat_step=remat_fwd['kernel']),
        'fused_cell_backward': dict(
            resumed_step=resumed['fused_backward']['kernel'],
            remat_step=remat_bwd['kernel']),
        'ctc_alpha': dict(resumed_step=resumed['ctc_alpha']['kernel']),
        'ctc_beta': dict(resumed_step=resumed['ctc_beta']['kernel'])}
    for entry in kernels:
        if entry['name'] in phase15:
            entry['launches_phase15'] = phase15[entry['name']]
    # phase 16's paths: the sweep (its first run, then on two worker
    # threads), the latency pass, the data-parallel steps and entry()
    for entry_row in kernels:
        key = {'fused_cell_forward': 'fused_forward',
               'fused_cell_backward': 'fused_backward'}.get(
                   entry_row['name'], entry_row['name'])
        if key in p16_launches['sweep']:
            entry_row['launches_phase16'] = {
                part: counts[key]['kernel']
                for part, counts in p16_launches.items()
                if counts[key]['kernel']}
    # phase 17's paths: the tp=2 and dp=2 x tp=2 f32 steps ('auto'), the
    # tp=2 'pallas' step, the 5 timed bf16 tp=2 steps, seq_parallel_apply
    # in both modes (rank 0's counts; every rank's are checked equal)
    for entry_row in kernels:
        key = {'fused_cell_forward': 'fused_forward',
               'fused_cell_backward': 'fused_backward'}.get(
                   entry_row['name'], entry_row['name'].replace(
                       'grouped_conv_', 'gconv_'))
        entry_row['launches_phase17'] = {
            part: counts[key]['kernel'] for part, counts in p17_launches.items()
            if counts[key]['kernel']}
    # phase 18's paths: the tone-corpus recipe's 40 epochs (steps and eval
    # batches), its int8 evaluation, the flagship's 3 epochs
    for entry_row in kernels:
        key = {'fused_cell_forward': 'fused_forward',
               'fused_cell_backward': 'fused_backward'}.get(
                   entry_row['name'], entry_row['name'])
        if key in p18_launches['flagship']:
            entry_row['launches_phase18'] = {
                part: counts[key]['kernel']
                for part, counts in p18_launches.items()}
    # phase 19's path, python -m nbasr_torch.bench: its launches a call,
    # counted by its own process around its timed windows
    for entry_row in kernels:
        key = {'fused_cell_forward': 'fused_forward',
               'fused_cell_backward': 'fused_backward'}.get(
                   entry_row['name'], entry_row['name'])
        if key in p19_launches['per_train_step']:
            entry_row['launches_phase19'] = {
                part: counts[key]['kernel']
                for part, counts in p19_launches.items()}
    kernels.append(dict(
        name='lstm_recurrence', route='cuda', source='nbasr_torch/csrc/lstm.cu',
        replaces=None, kernels=list(LSTM_KERNELS),
        launches_phase20=lstm_launches, per_case=lstm_rows))
    kernels.append(relpos)
    kernels.append(linear)
    kernels[0]['model_options_logits_vs_fused_share'] = {
        k: share for k, (share, _) in model_options.items()}
    print(f'train step: {train["step_ms"]:.3f} ms, '
          f'{train["audio_s_per_s"]:.1f} audio-s/s (fused), ' + ', '.join(
              f'{t["step_ms"]:.3f} ms, {t["audio_s_per_s"]:.1f} audio-s/s '
              f'({impl})' for impl, (_, t) in grouped_train.items())
          + f'; serving: {serving["step_ms"]:.3f} ms per device step; eval '
          f'(beam): {evaluation["eval_ms_per_batch"]:.3f} ms per batch; '
          f'proxies (B=1, T={NAS_FRAMES}, full width): ' + ', '.join(
              f'{name} {np.median([r["ms"] for r in nas_rows if r["proxy"] == name]):.3f} ms'
              for name in NAS_PROXIES)
          + f' a call (median over {len(NAS_ARCHS)} archs), first-call '
          f'planning {sum(r["plan_s"] for r in nas_rows):.3f} s in all; '
          + ', '.join(f'proxy_search({k}) {v["wall_s"]:.3f} s'
                      for k, v in nas_search['searches'].items())
          + f'; int8 serving: {p15["int8_serving"]["ms_per_step"]:.3f} ms '
          f'per device step, {p15["int8_serving"]["audio_s_per_s"]:.1f} '
          f'audio-s/s, {p15["int8_serving"]["resident_mb"]:.3f} MB resident; '
          f'checkpoint write {p15["checkpoint"]["write_s"]:.3f} s, read '
          f'{p15["checkpoint"]["read_s"]:.3f} s; sweep '
          f'{p16["sweep"]["wall_s"] / len(P16_ARCHS):.1f} s per arch-epoch; '
          f'benchmark_pass ' + ', '.join(
              f'{h[:8]} {v:.3f} ms' for h, v in p16['static']['bench_ms'].items())
          + ' a B=1 forward; tensor parallelism: a bf16 tp=2 step '
          f'{p17["bf16_step"]["step_ms"]:.3f} ms on two gloo ranks of one '
          f'card, seq_parallel_apply {p17["seq_chain"]["wall_ms"]:.3f} ms '
          f'(chain) against {p17["seq_chain"]["unsharded_ms"]:.3f} ms '
          f'unsharded; tone-corpus recipe best val LER '
          + ', '.join(f'{r["best"]:.4f}' for r in p18['recipe']['runs'].values())
          + f' (seeds {P18_SEEDS}); the flagship '
          f'{np.median(p18["flagship"]["epoch_seconds"]):.3f} s an epoch; '
          f'python -m nbasr_torch.bench: inference median '
          f'{1e3 * bench_line["inference_latency_median"]:.3f} ms, train step '
          f'{1e3 * bench_line["train_step_seconds"]:.3f} ms, '
          f'{bench_line["train_audio_seconds_per_sec_per_chip"]:.1f} '
          f'audio-s/s')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
