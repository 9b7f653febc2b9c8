#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`nsc_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Serves the `base_fast` codec at full width (weights made from seed 0, and
the trained flagship from its export) on 64 x 10 s of 16 kHz audio through
its three serving paths (unit_backend
"auto": K1; "pallas_ct_fused": K5; "pallas_fused": K6), trains it at full
width (TrainConfig defaults: batch 64 x 1 s, GAN with all discriminators)
and checks every hand-written kernel of those paths against its plain
PyTorch version; then serves, streams and trains every other registered
configuration at full width, and checks the trained `small` export. TF32 stays at PyTorch's defaults for the whole process, as
in a user's process: the codec's inference methods, the train step and
every plain version compared here run their float32 work under
`float32_numerics()` themselves. Phases, each printing JSON lines:

  1. device   the card's name and power limit
  2. build    the kernels, compiled from nsc_tpu_torch/csrc (seconds), with
              ptxas's registers and spills per kernel (no stage kernel may
              spill) and the HMMA (tensor-core) instructions of each stage
              kernel's instantiation and of each of rvq_quantize's two
              launch plans, counted with `cuobjdump -sass`: above 0 in the
              bf16 snake_fast (tensor-core) instantiations of K1, K5 and K6
              and in both K2 plans, exactly 0 in every float32 stage
              instantiation (no TF32); K2's two plans' registers and spills
              (the resident plan must not spill)
  3. kernels  each kernel against its plain version at the main paths'
              shapes: residual_stack (K1) and residual_stack_cl (K6) on all
              8 stages (B=64, full T) in bf16 and f32; fused_stage (K5) on
              all 8 stages with their real heads (strides 2/4/5 in) and
              tails (5/4/2 out) in bf16 and f32; rvq_quantize /
              rvq_dequantize at M=32000, 16 x 1024 x 128 (with K2's launch
              plan and its winning scores against float64 scores, gated at
              K2_SCORE_ULPS float32 ulps, and the codebook split bit-exact
              against its plain version); K2's
              streamed plan at M=32000 on 8 x 1024 x 256 and 4 x 1024 x 384
              (N(0, 1) books and frames); K3 also at a ragged M, at an odd
              D (4-byte rows), with indices outside [0, K), and the earlier
              row-warp design (timed beside it) on the serving indices;
              stft_magnitude (the FFT route) at the training step's six
              launch shapes (B=64, T=16000), at the k4_any bank's six and
              at K4_MIXED_SHAPES (speech windows, 8192, 12000), the
              chirp-z route at K4_BLUESTEIN_SHAPES (441, 2018, 2), both at
              the k4_chirp bank's four, the chirp-z cluster route at
              K4_CLUSTER_SHAPES (8191, 11025, 30000, 31999: clusters of 2,
              2, 4 and 8 blocks) and, with the FFT route, at the
              k4_cluster bank's four, the two-level chirp-z route (four
              kernels through global memory, beyond an 8-block cluster) at
              K4_GLOBAL_SHAPES (60001, 115202, 131072 and 262145 on 2-4
              rows of 4-20 s; against the plain version at 60001 only),
              each with its launch counted on its route's counter and
              against float64 magnitudes (2 float32 ulps; the plain
              float32 sums' reading beside it as a control), and its
              spectral loss (forward) against the float64 one; the
              cluster kernel bit for bit against the one-block chirp-z
              kernel given the same M and pass list (K4_CLUSTER_EQUAL:
              441 and 2018 at C 2, 4 and 8), and the two-level route
              against both (K4_GLOBAL_EQUAL); the spectral losses through
              the kernel against the plain path (values; the mel
              gradient), and the multi-resolution gradient of the kernel,
              the float32 matmul-DFT path and the float32 rfft path
              against a float64 matmul-DFT gradient, on five noise seeds,
              for the shipped bank, the k4_any bank, the k4_chirp bank
              and the k4_cluster bank
  4. main     serving: for each serving path, reconstruct with the launch
              counters reset just before and read just after (its stage
              kernel x8, K2 and its codebook split x1, K3 x1); a
              compress/decompress round trip ("auto"); index agreement and
              decode-only divergence of every serving path against the
              float32 path, and of the two opt-in paths against "auto".
              flagship (the trained base_fast, loaded from its export
              `exports/base_fast_synthetic2_48k_refit`): the fingerprint
              in meta.json; reconstruct of the 64 x 10 s batch with the
              counters around it (K1 x8, K2 and its split x1, K3 x1); the
              float32 path's indices on the 8 x 10 s noise and speech probes
              against nsc_tpu's CPU float32 reference (reference_f32.npz:
              a frame may differ only where its first differing book's
              reference margin is below 1e-3); the serving path run to run
              and against its GPU pin (exact when the pin's card and
              torch/CUDA/cuDNN versions are this run's); K2 against its
              plain version on the serving latents of the 64 x 10 s batch
              (near-tie rule); serving against float32 on the trained
              books (index agreement, decode divergence, margin
              percentiles, and the latents' relative error of K1 and of
              the serving config with its units op by op; reported).
              int8 (flagship): quantize_model of the serving bundle
              (default calibration), its reconstruct of the batch with the
              counters around it (K2 + split x1, K3 x1, the int8 product
              once per conv site, no stage kernel); the int8 product
              (im2col + torch._int_mm) bit-exact against its plain version
              at every conv site shape of 8 x 10 s, and timed at the
              batch's; drift against the float32 and "auto" paths
              (reported); the float32 int8 path with nsc_tpu's scales on
              both probes against reference_int8.npz (frame by frame
              reported; its agreement with nsc_tpu's float32 indices gated
              within INT8_AGREEMENT_TOL of nsc_tpu's int8 path's); the
              port's calibration against nsc_tpu's scales (reported).
              stacked: the float32 flagship with conv_backend "stacked",
              latents within STACKED_LATENT_TOL x max|z| of "reference",
              indices by the margin rule.
              streaming (flagship, 30 s of the speech probe in 1 s chunks):
              streaming_compress against compress (float32: the margin
              rule; serving: reported), streaming_decompress against
              decompress (finite, same length), push_many against
              sequential pushes (identical), the counters around a
              streaming compress and decompress at queue_chunks 4 and 1 (K2
              + split and K3 once per dispatch, nothing else), and every
              dispatch's K2 (near-tie rule) and K3 (bit-exact) against
              their plain versions on the dispatch's own inputs.
              cli: `python3 -m nsc_tpu_torch` compress (batch and
              --streaming 1.0), decompress and eval --ceiling --json on a
              10 s WAV of the speech probe: each stream's indices and the
              decoded WAV against the same calls in this process, eval's
              metrics finite; compress and decompress --int8 against the
              int8 bundle's calls in this process.
              trace (reported): profiling.trace around one "auto" and one
              int8 reconstruct of the batch and one streaming dispatch at
              queue 1, each window's top 10 kernels and idle share.
              doctor: `python3 -m nsc_tpu_torch doctor --json` in a fresh
              process: rc 0, device "ok", the card's name.
              training: seeded full-width state, step-0 data init of the
              codebooks, 2 + 5 steps with the counters reset just before
              the data init and read after the last step; then the entry
              point (`nsc_tpu_torch.train.loop.main`) for 2 steps into a
              temporary workdir and a resume to step 3.
              k4_any: base_fast at full width with the loss STFTs at n_fft
              8192/2400/960/480/120 and the mel STFT at 400 (all on K4's
              FFT route), 2 steps, each beside the same step with the plain
              STFT (losses within LOSS_RTOL), K4 x12, no chirp-z route, K2
              + split x1 per step; step time and peak memory.
              k4_chirp: the same with the loss STFTs at 12000/2018/441 and
              the mel STFT at 441: K4's FFT route x2 (12000, one-buffer
              plan) and chirp-z route x6 a step.
              k4_cluster: the same with the loss STFTs at 11025/8191/1024
              and the mel STFT at 1024: K4's chirp-z cluster route x4 and
              FFT route x4 a step.
              loop: the entry point (`loop.parse_args`, then `loop.run`
              with a metrics row per step) at full width on a WAV
              directory (synthetic2 rows and speech-probe rows, one at
              22.05 kHz in stereo) and on synthetic2:pool=256, a
              checkpoint every step and a full state every 2, 2 kept:
              5 steps, and 3 then a resume to 5, under
              `deterministic()`; gated: the kept full states and
              exports, best.json, the resumed run's metrics
              rows equal to the uninterrupted run's, the threaded step-3
              snapshot equal to a synchronous save of the live state,
              infer_best/ and infer/ equal to the live state at their
              steps, the float32 bundle of infer/ encoding as the final
              state, K2 + split x1 and K4 x12 per step (+ K2 x48 per data
              init), and the workdir served (K1 x8, K2 + split x1, K3 x1).
              refit, for seeds 7 and 8: 25,600 frames of synthetic2 through
              the flagship's float32 encoder, refit_codebooks (k-means 10)
              between two pool_reports: the residual MSE falls at every
              depth, every K2 search held against plain and float64
              (`hold_refit_search`, 0 K2 errors), K2 + split x (16 x 11 + 2)
              per seed.
              finetune: run_finetune on the flagship export, 4 steps at
              batch 64 x 1 s on synthetic2:pool=256, held-out mel every 2:
              only decoder leaves move, K2 + split x1 and K4 x12 per step
              (+ K2 x1 for the held-out batch), the workdir served
              close: `python -m nsc_tpu_torch.train` at full width
              (synthetic2, 6 steps, an export every step, a full state
              every 2) under the watchdog (`train/watchdog.py`, 1 s poll)
              with the harvester on a thread (0.2 s poll), SIGKILLed once
              after its step-3 export: one restart, rc 0, the resume from
              the newest full state at the kill, harvest/ 1-6 each with its
              sha256, infer/ 4-6, no *.tmp left, the relaunched trainer's
              K2 + split x1 and K4 x12 a step; then on the card the
              held-out trend over the six harvested steps (16 x 17,600 and
              4 x 10 s at depth 16: rows finite, none added by a second
              call, K1 x16, K2 + split x2, K3 x2 a step), the smoothed
              winner, `pick_export_step`, the winner's export with its GPU
              pin (re-check exact), and that export served (K1 x8, K2 +
              split x1, K3 x1)
              configs: each of base, base_noncausal, base_fast_f, small
              and small_factorized at full width with seed-0 weights on
              the 64 x 10 s batch: the serving bundle's reconstruct with
              the counters around it (K1 x8, none for base_noncausal, whose
              units run op by op; K2 + split x1, K3 x1), its RTF; for base,
              the serving activation snake_fast and its indices equal to
              base_fast's serving bundle's on the same weights; K1 on each
              stage it runs (bf16, K1_TOL), K2 on the bundle's latents
              (near-tie rule, scores within K2_SCORE_ULPS of float64) and K3
              (bit-exact) against plain at the configuration's shapes, each
              timed beside its bound; the float32 path on the card against
              the port's CPU float32 path on 2 x 10 s (margin rule; the
              decodes' divergence and serving's agreement reported);
              streaming of 30 s of the batch in 1 s chunks at queue 4 (a
              round trip, K2 + split and K3 once per dispatch) or, for
              base_noncausal, its refusal (ValueError); 2 full-width
              training steps (TrainConfig defaults: 64 x 1 s, GAN on,
              data-initialised books; finite metrics, K2 + split x1 and K4
              x12 a step, step ms by CUDA events, peak memory); then the
              CLI's default model (base, float32) compress and decompress
              in fresh processes against the same calls here (margin rule,
              the WAV within CLI_PCM_TOL).
              small_trained: the trained small export
              (exports/small_synthetic_30k): its fingerprint, the float32
              path on both probes against reference_f32.npz (margin rule),
              serving run to run and against its GPU pin, the float32 sweep
              against reference_sweep.json and the serving sweep counted
              (as sweep), and a CLI round trip of the serving bundle
              (exact)
  5. timing   reconstruct wall time and real-time factor of each serving
              path, of the flagship's "auto" and int8 serving bundles, and
              of its float32 bundle with "reference" and "stacked" convs; streaming_compress and streaming_decompress real-time
              factors of the flagship's serving bundle at queue_chunks 4
              and 1, and K2 and K3 beside their plain versions (in turns)
              on one dispatch's inputs at each; the wall seconds of each
              CLI call; the train step's time, audio seconds per second, peak
              memory and split; each kernel's time beside its plain
              version's, its bound and a PyTorch yardstick where one call
              computes the same function (K4 at every shape it checks, the
              kernel and `torch.stft` + `abs` in turns, and at the k4_any,
              k4_chirp and k4_cluster banks'); K4's
              backward beside its forward
              and beside the plain recompute it replaced; K3 beside the
              row-warp design and beside its L2 gather floor (the bytes it gathers
              over the L2 read rate of one PyTorch reduction of an
              L2-resident 8 MB tensor, reported, not gated); the host
              sources' seconds per batch of 64 x 1 s beside the step, the
              threaded snapshot's cost to the step (windows of steps alone
              and with a full-state submit, in turns), the full state's
              and an export's bytes, the refit's and the finetune's seconds;
              the close's stages: the supervised run, the watchdog's
              relaunch after the kill, the trend per harvested step, the
              pick, the export with its pin; each configuration's RTF,
              K1/K2/K3 ms beside their bounds, step ms and peak memory

then the `kernels` summary line, the card line and, last,
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero.
Without CUDA, or without the package beside it, it exits non-zero and prints
no result.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

# Published H100 SXM peaks at the 700 W limit (NVIDIA data sheet), used for
# the bound of each kernel: dense bf16 tensor-core rate, float32 rate outside
# the tensor cores, HBM3 bandwidth. A stage kernel's bound is the larger of
# bytes / PEAK_BYTES and its operations at the bf16 rate: K1's bf16 products
# unit_flops / PEAK_BF16_FLOPS; K5's and K6's float32-weight products, each
# float32-exact as three bf16 MMAs (bf16 planes hi + mid + lo of the weight),
# 3 x unit_flops / PEAK_BF16_FLOPS, plus K5's head and tail (bf16 weights)
# edge_flops / PEAK_BF16_FLOPS.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12  # float64 outside the tensor cores (K4's FFT computes in float64; printed)
PEAK_BYTES = 3.35e12

# Tolerances of the kernel checks, against the plain version on the same
# inputs. residual_stack float32: only the summation order of 3C- and
# C-term float32 dot products differs (~1e-6 relative per unit), so
# 1e-5 x max|ref|. bfloat16: a float32 sum that lands on the other side of
# a bf16 rounding boundary flips one ulp (2^-7 relative) and the flip
# propagates through later units, so 2e-2 x max|ref| (a few ulps at the
# largest values) on the max and 1e-3 x max|ref| on the mean. K5 and K6 run
# the same unit chain (K5 adds a head or tail whose float32 sums differ the
# same way), so they take K1's tolerances.
# rvq_quantize: a different index is allowed only where the plain version's
# top-2 score margin is below 1e-3 (scores are ~1e2-1e3; float32 dots of
# 128-384 terms differ by ~1e-5 with the order). rvq_dequantize and the
# codebook split: bit-exact.
# stft_magnitude (either route): float32 sums in another order or an FFT's
# rounding: 1e-4 x max|ref|. Spectral losses through it: values rtol 1e-5;
# the mel loss's gradient 1e-4 x max|g| against the plain path's.
K1_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-3)}
K2_NEAR_TIE = 1e-3
# K2 rescores its shortlist exactly (float64 dot and score, rounded once),
# so its winning scores lie within half a float32 ulp of the float64 score
# of the same (frame, book, index) but for the float64 sum's own rounding:
# gated at 2 ulps
K2_SCORE_ULPS = 2.0
K4_TOL = 1e-4
LOSS_RTOL = 1e-5
LOSS_GRAD_TOL = {"mel": 1e-4}
# The multi-resolution loss's gradient is held to the true gradient, not to
# the float32 plain path's rounding: on each noise seed (the reconstruction
# is the target + 0.05 x N(0, 1) from that seed), e(g) = ||g - g64||_2 /
# ||g64||_2 against the float64 matmul-DFT path (float64 input, window and
# basis), and K4's e must be at most K4_F64_RATIO x the float32 plain
# path's and at most K4_F64_L2_TOL. L2, not max-abs: the log-magnitude term
# is an L1, its gradient flips sign at bins where reconstruction and target
# nearly tie, and a handful of such flips set a max-abs distance. The fixed
# limit is 2 x the plain path's largest reading over the five seeds on an
# H100 (scripts/torch_k4_gradient.py; the plain path does not run K4):
# 1.4055e-3, 1.4268e-3, 5.1575e-3, 1.5578e-3, 1.4570e-3 at seeds 2-6.
K4_GRAD_SEEDS = (2, 3, 4, 5, 6)
K4_F64_RATIO = 1.25
K4_F64_L2_TOL = 1.0315e-2
# K4's routes beyond the shipped bank, on the 64 x 1 s target. The FFT
# route (n_fft even, its half 7-smooth, up to 29,056) at the 25 and 20 ms
# windows of 16 kHz, 20 ms at 24, 44.1 and 48 kHz, 8192 and 12000; the
# chirp-z route at an odd n_fft (441 = 3^2 7^2), a half with a prime factor
# above 7 (2018 = 2 x 1009) and the smallest n_fft. Each against its plain
# version (K4_TOL) and against float64 magnitudes (float64 rfft of the
# float64-windowed frames): every route computes in float64 and rounds
# once, so every magnitude within K4_F64_ULPS float32 ulps. The control,
# printed beside each reading: the plain version's float32 sums against
# the same float64 magnitudes.
K4_MIXED_SHAPES = ((400, 100), (320, 80), (480, 120), (882, 220), (960, 240), (8192, 2048),
                   (12000, 3000))
K4_BLUESTEIN_SHAPES = ((441, 110), (2018, 504), (2, 1))
# The chirp-z cluster route (the chirp-z transform over a thread-block
# cluster's distributed shared memory: odd n_fft 7,205-57,599, even ones
# 14,408-115,200 off the FFT route) at odd n_fft above the one-block plan's
# limit (8191: C 2; 11025, 250 ms at 44.1 kHz: C 2; 31999: C 8) and a smooth
# even one above the FFT's (30000: C 4). The cluster kernel bit for bit
# against the one-block kernel given the same M and pass list: (n_fft, C)
# at shapes both run.
K4_CLUSTER_SHAPES = ((8191, 2048), (11025, 2756), (30000, 7500), (31999, 8000))
K4_CLUSTER_EQUAL = tuple((n, c) for n in (441, 2018) for c in (2, 4, 8))
# The two-level chirp-z route (four kernels through global memory: odd
# n_fft from 57,601, even ones from 115,202) at (n_fft, hop, rows,
# samples): 60001 on 4 x 4 s (odd, M 120,960, C 30; its plain version's two
# float32 bases are 14.4 GB on the card, their float64 construction on the
# host dropped after the shape's checks), 115202 on 4 x 4 s (even, half
# 57601 prime: M 115,248, C 42), 131072 = 2^17 on 4 x 8 s (M 131,072, C 32)
# and 262145 on 2 x 20 s (odd, M 524,880, C 135); against the plain version
# at 60001 only, against float64 at all four. Bit for bit against the
# one-block kernel (441 and 2018 at C 2, 4, 8 and 16) and against the
# cluster kernel at the cluster route's plans (8191: C 2, 30000: C 4,
# 31999: C 8) given the same M and pass list.
K4_GLOBAL_SHAPES = ((60001, 15000, 4, 64000), (115202, 28800, 4, 64000),
                    (131072, 32768, 4, 128000), (262145, 65536, 2, 320000))
K4_GLOBAL_PLAIN = (60001,)
K4_GLOBAL_EQUAL = tuple((n, c, "one-block") for n in (441, 2018) for c in (2, 4, 8, 16)) + (
    (8191, 2, "cluster"), (30000, 4, "cluster"), (31999, 8, "cluster"))
K4_F64_ULPS = 2.0
# The k4_any phase: base_fast trained at full width (TrainConfig defaults
# but the loss STFTs) with a bank whose n_fft are not powers of two, and
# 8192, all on the FFT route; K4_ANY_STEPS steps, each beside the same step
# with the plain STFT. Its launch shapes (hop n/4) are also held against
# plain and float64 in the kernel checks.
K4_ANY_BANK, K4_ANY_MEL, K4_ANY_STEPS = (8192, 2400, 960, 480, 120), 400, 2
K4_ANY_SHAPES = tuple((n, n // 4) for n in K4_ANY_BANK + (K4_ANY_MEL,))
# The k4_chirp phase: the same, with a bank whose every resolution takes a
# route the two-buffer FFT plan could not: 12000 (the one-buffer FFT), 2018
# and 441 (the chirp-z transform), and the mel STFT at 441; K4_ANY_STEPS
# steps. Its launch shapes are also held against plain and float64, and
# its multi-resolution gradient is gated on K4_GRAD_SEEDS.
K4_CHIRP_BANK, K4_CHIRP_MEL = (12000, 2018, 441), 441
K4_CHIRP_SHAPES = tuple((n, n // 4) for n in K4_CHIRP_BANK + (K4_CHIRP_MEL,))
# The k4_cluster phase: the same, with a bank whose two longest
# resolutions take the cluster route (11025 and 8191) and 1024 the FFT, the
# mel STFT at 1024; K4_ANY_STEPS steps. Its launch shapes are also held
# against plain and float64, and its multi-resolution gradient is gated on
# K4_GRAD_SEEDS.
K4_CLUSTER_BANK, K4_CLUSTER_MEL = (11025, 8191, 1024), 1024
K4_CLUSTER_BANK_SHAPES = tuple((n, n // 4) for n in K4_CLUSTER_BANK + (K4_CLUSTER_MEL,))
# the route each checked K4 shape must take
K4_ROUTE = {**{n: "bluestein" for n, _ in K4_BLUESTEIN_SHAPES},
            **{n: "bluestein_cluster" for n, _ in K4_CLUSTER_SHAPES},
            **{n: "bluestein_global" for n, *_ in K4_GLOBAL_SHAPES}, 2018: "bluestein",
            441: "bluestein"}
# K2's streamed plan (padded widths over 128): (n_q, K, D) at M frames
K2_WIDE = ((8, 1024, 256), (4, 1024, 384))
K2_WIDE_M = 32000
# The L2 read rate K3's gather floor is taken at: one reduction over this
# many repeats of an 8 MB float32 tensor (it stays in the 50 MB L2)
L2_PROBE_FLOATS, L2_PROBE_REPEATS = 2 * 1024 * 1024, 32

BATCH, SECONDS = 64, 10.0
# (path, unit_backend, the route of its residual units)
SERVING_PATHS = (("serving", "auto", "residual_stack"),
                 ("serving_fused_boundary", "pallas_ct_fused", "fused_stage"),
                 ("serving_channels_last", "pallas_fused", "residual_stack_cl"))
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# The trained flagship, exported for the port (scripts/export_torch_checkpoint.py)
# with nsc_tpu's CPU float32 indices and argmin margins on the canonical
# probes (reference_f32.npz) and the port's GPU pin (canonical_idx_gpu.npz).
# Its float32 indices are held to that reference under K2_NEAR_TIE: a frame
# may differ only where its first differing book's reference margin is below
# it (two float32 encoders agree to ~1e-6 relative on the latents, which
# moves a score of ~1e1-1e2 by ~1e-4 at most).
FLAGSHIP = "base_fast"
EXPORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "exports",
                      "base_fast_synthetic2_48k_refit")
# streaming: three rows of the speech probe end to end (30 s) in 1 s chunks
STREAM_ROWS, STREAM_CHUNK_SECONDS = 3, 1.0
# The training loop's entry point (`loop_smoke`): LOOP_STEPS steps with a
# checkpoint every step and a full state every 2 (full at 1, 3, 5), the
# newest LOOP_KEEP full states kept; pools of LOOP_POOL synthetic2
# segments; each host source timed over SOURCE_BATCHES batches after its
# first. LOOP_ARGS: more arguments of the entry point (none at full
# width), which also set the TrainConfig of the host-source timing and of
# the snapshot's cost. SNAPSHOT_TURNS: turns of that cost, each a window of
# SNAPSHOT_WINDOW steps without a snapshot and one with a snapshot after its
# first step.
LOOP_STEPS, LOOP_KEEP, LOOP_POOL, SOURCE_BATCHES = 5, 2, 256, 2
LOOP_ARGS = []
SNAPSHOT_TURNS, SNAPSHOT_WINDOW = 6, 2
# The flagship's refit (`refit_smoke`): REFIT_BATCHES x REFIT_BATCH x 1 s of
# synthetic2 from each of REFIT_SEEDS (25,600 frames), k-means REFIT_ITERS
# iterations, as the flagship's own refit (artifacts/.../meta.json: 10).
# Seed 8 is the refit on which K2 without its rescoring missed the float64
# argmin (ROADMAP.md, C6).
REFIT_SEEDS, REFIT_BATCH, REFIT_BATCHES, REFIT_ITERS = (7, 8), 64, 8, 10
# int8 serving (`int8_smoke`): the int8 product held against its plain
# version bit for bit at the conv sites of INT8_CHECK_ROWS x 10 s. The
# int8 tensor-core peak (dense) bounds its operations.
INT8_CHECK_ROWS = 8
PEAK_INT8_OPS = 1979e12
# The float32 int8 path with nsc_tpu's scales against nsc_tpu's CPU int8
# reference (reference_int8.npz). Not frame by frame: each conv re-quantizes
# its input, so a one-ulp float difference on a rounding boundary moves a
# code by a step that spreads through the later convs, and nsc_tpu's own
# int8 path, jitted against eager on the same CPU, differs on most frames of
# 2 s of the noise probe (scripts/int8_reference_spread.py). Gated instead:
# each path's index agreement with nsc_tpu's float32 reference
# (reference_f32.npz), over all books and over book 0, within this of the
# other's (on the CPU, 2 rows: 0.0003-0.0015 apart).
INT8_AGREEMENT_TOL = 0.02
# conv_backend "stacked" (`stacked_smoke`): the same float32 sums in another
# order, ~1e-7 relative per conv through 30 convs
STACKED_LATENT_TOL = 1e-5
# The decoder finetune (`finetune_smoke`): FINETUNE_STEPS steps of
# finetune_config(batch_size=64), held-out eval every 2 steps
FINETUNE_STEPS = 4
FINETUNE_OVERRIDES = {}
# Data parallelism (`dp_smoke`): DP_STEPS steps of a one-rank group beside
# the plain step, and the entry point through torch.distributed.run.
DP_STEPS = 2
DP_OVERRIDES = {}
# The run-closing tools (`close_smoke`): CLOSE_STEPS steps of the training
# entry point under the watchdog, SIGKILLed once after its CLOSE_KILL_AT
# export appears; the watchdog's grace and stale limits above the whole
# run, so that only the kill restarts it. CLOSE_ARGS: more arguments of
# the trainer (none at full width); CLOSE_TREND: the held-out trend's
# batches (none: its defaults, 16 x 17,600 samples and 4 x 10 s, depth 16).
CLOSE_STEPS, CLOSE_KILL_AT = 6, 3
CLOSE_GRACE_S, CLOSE_STALE_S = 600.0, 300.0
CLOSE_ARGS = []
CLOSE_TREND = {}
# The trainer under the watchdog: `python -m nsc_tpu_torch.train` run by
# runpy, writing its kernel launch counts to <prefix>.<pid> when it exits
# (a SIGKILLed trainer writes none).
COUNTING_TRAINER = (
    "import json, os, runpy, sys\n"
    "from nsc_tpu_torch import kernels\n"
    "prefix = sys.argv.pop(1)\n"
    "try:\n"
    "    runpy.run_module('nsc_tpu_torch.train', run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    with open(f'{prefix}.{os.getpid()}', 'w') as f:\n"
    "        json.dump(dict(kernels.LAUNCHES), f)\n")
# The bitrate sweep (`sweep_smoke`) of the float32 flagship against
# nsc_tpu's CPU rows (reference_sweep.json), at each depth where the two
# index sets are equal: the index-derived fields exactly, and each float
# field within (rtol, atol). There the two float32 reconstructions differ by
# float32 rounding only: the port's CPU sweep of these clips moved the
# smooth metrics by at most 1.7e-6 relative (pesq_proxy) and si_snr_db by
# 6.8e-7 dB, so 1e-4 relative and 1e-3 dB leave the card's convolutions
# ~60x room; Taal's STOI drops silent frames by a hard 40 dB threshold, so
# it is held in absolute terms (2e-3, tests/test_torch_sweep.py).
SWEEP_INDEX_FIELDS = ("entropy_bitrate_bps", "book_perplexity", "book_usage")
SWEEP_TOL = {"si_snr_db": (0.0, 1e-3), "mel_distance": (1e-4, 1e-6),
             "pesq_proxy": (1e-4, 1e-6), "stoi_proxy": (1e-4, 1e-6),
             "visqol_nsim": (1e-4, 1e-6), "stoi": (0.0, 2e-3)}


# The registered configurations beside base_fast (`configs_smoke`), each at
# full width with seed-0 weights, uncut, on the main phase's 64 x 10 s:
# serving with the counters around reconstruct, K1/K2/K3 against plain at
# the configuration's shapes, the float32 path on the card against the
# CPU's on CONFIG_F32_ROWS x 10 s (the margin rule), streaming (causal
# configurations; STREAM_ROWS x 10 s of the main input in 1 s chunks at
# queue CONFIG_QUEUE), CONFIG_TRAIN_STEPS training steps of TrainConfig(),
# then one CLI round trip with the CLI's default model. CLI_PCM_TOL: two
# decodes of the same indices in two processes, float32 on cuDNN, within
# two 16-bit PCM steps.
CONFIGS = ("base", "base_noncausal", "base_fast_f", "small", "small_factorized")
CONFIG_F32_ROWS, CONFIG_QUEUE, CONFIG_TRAIN_STEPS = 2, 4, 2
CLI_PCM_TOL = 2.0 / 32768
# The trained `small` checkpoint (`small_trained_smoke`), exported as the
# flagship is, with its GPU pin; bench_suite.py's config 5 sweeps it
SMALL_EXPORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "exports",
                            "small_synthetic_30k")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def f32_ulp(x):
    """The float32 spacing at |x| (a float64 tensor), as float64."""
    import torch

    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


STAGE_KERNELS = ("residual_stack_cl", "residual_stack", "fused_stage")


def kernel_label(symbol: str) -> str:
    """A readable name for a kernel symbol (mangled, or ptxas's line): the
    stage kernels as name<dtype,activation[,tc]>."""
    m = re.search(r"(residual_stack_cl|residual_stack|fused_stage|rvq_quantize"
                  r"|rvq_dequantize_rowwarp|rvq_dequantize|rvq_split_planes"
                  r"|stft_magnitude_bluestein_global_(?:cross_dif|share|cross_dit|end)"
                  r"|stft_magnitude_bluestein_cluster|stft_magnitude_bluestein|stft_magnitude)"
                  r"(_tc)?_kernel", symbol)
    if m is None:
        return symbol
    if m.group(1) == "stft_magnitude_bluestein_cluster":  # one instantiation per cluster size
        c = re.search(r"_kernelILi(\d)E", symbol)
        return "stft_magnitude_bluestein_cluster<%s>" % (c.group(1) if c else "?")
    if m.group(1) == "stft_magnitude":
        return "stft_magnitude<%s>" % ("pairs" if "Lb1E" in symbol else "one pass")
    if m.group(1) == "rvq_quantize":
        return "rvq_quantize<%s>" % ("streamed" if "Lb1E" in symbol else "resident")
    if m.group(1) == "rvq_dequantize":
        return "rvq_dequantize<%s>" % ("float4" if "Li4E" in symbol else "float")
    if m.group(1) not in STAGE_KERNELS:
        return m.group(1)
    if m.group(2):
        return f"{m.group(1)}<bf16,snake_fast,tc>"
    return "%s<%s,%s>" % (m.group(1), "bf16" if "bfloat16" in symbol else "f32",
                          "snake_fast" if "Lb1E" in symbol else "snake")


HMMA_KERNELS = STAGE_KERNELS + ("rvq_quantize",)


def hmma_counts(lib_path: str, cuda_bin: str) -> dict:
    """HMMA instructions in each stage-kernel instantiation and in each
    launch plan of the quantize kernel of the built library, from
    `cuobjdump -sass`."""
    out = subprocess.run([os.path.join(cuda_bin, "cuobjdump"), "-sass", lib_path],
                         capture_output=True, text=True, check=True, timeout=300).stdout
    counts, label = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            label = kernel_label(ln.split("Function :", 1)[1].strip())
            label = label if label.startswith(HMMA_KERNELS) else None
            if label is not None:
                counts.setdefault(label, 0)
        elif label is not None and re.search(r"\bHMMA\b", ln):
            counts[label] += 1
    return counts


# K4's bound is the least work |STFT| needs, the function the TPU kernel
# computes: each input sample read once, each magnitude written once, and
# per frame the operations of a real FFT (2.5 n log2 n, half of a complex
# FFT's 5 n log2 n), the window (n) and the magnitudes (4 per bin), at the
# float32 rate of the function's data. Returned beside it and not in the
# bound: the port's own extra work, the spectrum (re, im) that the
# reconstruction's launches also write for the backward (spectrum_bytes_ms)
# and the FFT's operations at the float64 rate it computes in (f64_ops_ms).
def k4_bound(b, t, n_fft, hop):
    from nsc_tpu_torch.ops import stft as S

    # the frames the wrapper writes (an odd n_fft loses the last one where
    # hop divides t)
    frames = S.num_frames(t + 2 * (n_fft // 2), n_fft, hop, center=False)
    bins = n_fft // 2 + 1
    flops = b * frames * (2.5 * n_fft * math.log2(n_fft) + n_fft + 4 * bins)
    nbytes = 4 * (b * t + b * frames * bins + n_fft)
    spectrum_bytes = 4 * 2 * b * frames * bins
    return (flops, nbytes, nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3,
            spectrum_bytes / PEAK_BYTES * 1e3, flops / PEAK_F64_FLOPS * 1e3)


def torch_stft_abs(x, n_fft, hop, win):
    """The library yardstick of K4: one `torch.stft` and its `abs`."""
    import torch

    return torch.stft(x, n_fft, hop_length=hop, window=win, center=True, pad_mode="reflect",
                      return_complex=True).abs()


def k4_spectrum64(x, n_fft, hop):
    """Float64 `torch.fft.rfft` of x's frames times the float64 window (the
    yardstick of K4's float64 contract; the port never calls it)."""
    import torch

    from nsc_tpu_torch.ops import stft as S

    frames = S.frame_signal(x.double(), n_fft, hop) * S.hann_window(n_fft, x.device, torch.float64)
    return torch.fft.rfft(frames, dim=-1)


def k4_float64(x, n_fft, hop):
    """The magnitudes of `k4_spectrum64`, with the same 1e-8 under the root."""
    import torch

    z = k4_spectrum64(x, n_fft, hop)
    return torch.sqrt(z.real ** 2 + z.imag ** 2 + 1e-8)


@contextlib.contextmanager
def plain_stft():
    """The spectral losses with `stft=stft_magnitude_plain` while the block
    runs (the train step calls them through the module), then restored."""
    import functools

    from nsc_tpu_torch.kernels import stft as KS
    from nsc_tpu_torch.losses import spectral as SP

    originals = {name: getattr(SP, name) for name in ("multi_res_stft_loss", "mel_loss")}
    for name, fn in originals.items():
        setattr(SP, name, functools.partial(fn, stft=KS.stft_magnitude_plain))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(SP, name, fn)


def k4_timing(pred, target, n_fft, hop, events_ms, plain_reps=3) -> dict:
    """One K4 launch shape on 64 x 1 s: the kernel on the target (`ms`) and
    on the reconstruction keeping the spectrum (`ms_spectrum`, as the loss
    launches it), its plain version (mean of `plain_reps` calls after one;
    None for 0),
    `torch.stft` + `abs`, in turns (kernel, library, library, kernel), and
    the bound."""
    import torch

    from nsc_tpu_torch.kernels import stft as KS
    from nsc_tpu_torch.ops import stft as S
    from nsc_tpu_torch.ops.precision import float32_numerics

    win = S.hann_window(n_fft, target.device)
    kernel = lambda: KS.stft_magnitude(target, n_fft, hop)  # noqa: E731
    library = lambda: torch_stft_abs(target, n_fft, hop, win)  # noqa: E731
    turns = [events_ms(fn, reps=10) for fn in (kernel, library, library, kernel)]
    plain_ms = None
    if plain_reps:
        with float32_numerics():
            plain_ms = events_ms(lambda: KS.stft_magnitude_plain(target, n_fft, hop),
                                 reps=plain_reps)
    b, t = target.shape
    _, _, bytes_ms, ops_ms, _, f64_ops_ms = k4_bound(b, t, n_fft, hop)
    row = {"route": KS.route(n_fft), "n_fft": n_fft, "hop": hop, "B": b, "T": t,
           "ms": (turns[0] + turns[3]) / 2,
           "ms_spectrum": events_ms(lambda: KS.launch(pred, n_fft, hop, spectrum=True), reps=20),
           "plain_ms": plain_ms, "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms > ops_ms else "operations", "f64_ops_ms": f64_ops_ms}
    del win
    return row


def k4_check(x, n_fft, hop, what: str, plain: bool = True):
    """K4 at one launch shape on x, with the counters around it: its route
    (K4_ROUTE), one launch on its counter and none on another, the plain
    version's shape, finite values, within K4_TOL x max|plain| of the plain
    version (with `plain`; else the float64 magnitudes' shape, the error
    None), and within K4_F64_ULPS float32 ulps of float64 magnitudes, the
    plain version's float32 sums' reading beside it as a control. Returns
    (route, max abs error, float64 reading, control)."""
    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.kernels import stft as KS
    from nsc_tpu_torch.ops.precision import float32_numerics

    kind = KS.route(n_fft)
    check(kind == K4_ROUTE.get(n_fft, "fft"), f"K4 n_fft={n_fft}: route {kind}")
    name = KS.COUNTERS[kind]
    kernels.reset_launches()
    got = KS.stft_magnitude(x, n_fft, hop)
    torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] for k in KS.COUNTERS.values()}
    m64 = k4_float64(x, n_fft, hop)
    unit = f32_ulp(m64)
    f64 = ((got.double() - m64).abs() / unit).max().item()
    err = scale = control = None
    if plain:
        with float32_numerics():
            ref = KS.stft_magnitude_plain(x, n_fft, hop)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        control = ((ref.double() - m64).abs() / unit).max().item()
        del ref
    emit({"phase": "kernel_check", "kernel": name, "route": kind,
          "input": what, "B": x.shape[0], "T": x.shape[1], "n_fft": n_fft, "hop": hop,
          "shape": list(got.shape), "launches": launched, "max_abs_err": err,
          "max_abs_ref": scale, "max_rel_err": err / scale if plain else None,
          "float64_max_ulps": f64, "plain_float32_control": control})
    check(launched == {k: int(k == name) for k in KS.COUNTERS.values()},
          f"K4 n_fft={n_fft}: launches {launched}")
    check(tuple(got.shape) == tuple(m64.shape), f"K4 n_fft={n_fft}: shape")
    check(torch.isfinite(got).all().item(), f"K4 n_fft={n_fft}: non-finite output")
    check(not plain or err <= K4_TOL * scale, f"K4 n_fft={n_fft} {what}: max abs err {err}")
    check(f64 <= K4_F64_ULPS, f"K4 n_fft={n_fft} {what}: {f64} ulps from float64")
    return kind, err, f64, control


# The plain version's bases at the largest n_fft chip_smoke.py checks are
# built by numpy in float64 on the host: ~2 minutes of one core for 60001
# (~40 GB at the peak), ~30 s each for 30000 and 31999. Two threads build
# them (numpy's loops release the interpreter lock: 60001 on one, 31999 and
# 30000 on the other, ~55 GB at the peak) while the CLI phase runs, which
# takes no timing (its subprocesses' wall seconds are printed, not used);
# the phase after it waits for them, so no timed phase runs beside them.
PLAIN_BASIS_PREFETCH = (K4_GLOBAL_PLAIN, (31999, 30000))
# the cluster shapes checked and timed with the two-level route's, before
# the other K4 checks, while their prefetched bases are cached
K4_CLUSTER_LARGE = tuple((n, h) for n, h in K4_CLUSTER_SHAPES
                         if n in sum(PLAIN_BASIS_PREFETCH, ()))


def plain_basis_prefetch():
    """Start building the float32 plain bases of PLAIN_BASIS_PREFETCH into
    `ops.stft`'s cache, a thread for each group; returns a join() that
    re-raises what a thread raised and returns each n_fft's build seconds."""
    import threading

    import numpy as np

    from nsc_tpu_torch.ops import stft as S

    failure, seconds = [], {}

    def build(group):
        try:
            for n_fft in group:
                t0 = time.perf_counter()
                S._dft_basis_np(n_fft, np.float32)
                seconds[n_fft] = time.perf_counter() - t0
        except BaseException as e:  # re-raised by join
            failure.append(e)

    threads = [threading.Thread(target=build, args=(group,), name="plain-basis-prefetch",
                                daemon=True) for group in PLAIN_BASIS_PREFETCH]
    for thread in threads:
        thread.start()

    def join():
        for thread in threads:
            thread.join()
        if failure:
            raise failure[0]
        return seconds

    return join


def k4_global_smoke(dev, card, events_ms):
    """The two-level chirp-z route, which no shipped bank reaches, at
    K4_GLOBAL_SHAPES on N(0, 0.3^2) noise: checked (`k4_check`, against the
    plain version at K4_GLOBAL_PLAIN only; the spectrum it keeps for the
    backward within K4_F64_ULPS of float64's re and im, in float32 ulps of
    the bin's magnitude) and timed (`k4_timing`, its
    plain version once after one where checked against it: each plain call
    copies its 14.4 GB of bases to the card); then its spectral loss as a
    user evaluates it (the multi-resolution loss at the shape's n_fft, hop
    n_fft/4, of the noise plus 0.05 N(0, 1) against the noise, forward),
    with the counters reset just before and read just after: two launches
    on its counter and none on another, the value within LOSS_RTOL of the
    loss on float64 magnitudes rounded to float32. The plain version's
    cached bases are dropped after. Returns the kernels-line entry of
    stft_magnitude_bluestein_global and the loss's launch counts."""
    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.kernels import stft as KS
    from nsc_tpu_torch.losses import spectral as SP
    from nsc_tpu_torch.ops import stft as S

    gen = torch.Generator(device=dev).manual_seed(4)
    err, f64, control, rows, losses, spectrum_ulps = 0.0, 0.0, {}, [], [], 0.0
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    name = KS.COUNTERS["bluestein_global"]
    with torch.no_grad():
        for n_fft, hop, b, t in K4_GLOBAL_SHAPES:
            x = torch.randn(b, t, device=dev, generator=gen) * 0.3
            plain = n_fft in K4_GLOBAL_PLAIN
            _, e, f, c = k4_check(x, n_fft, hop, "target", plain=plain)
            err, f64, control[f"{n_fft}/{hop}"] = max(err, e or 0.0), max(f64, f), c
            # the spectrum the backward reads: re and im, each rounded once,
            # within K4_F64_ULPS of float64 in ulps of the bin's magnitude
            _, re_, im_ = KS.launch(x, n_fft, hop, spectrum=True)
            z = k4_spectrum64(x, n_fft, hop)
            unit = f32_ulp(z.abs())
            spec = max(((re_.double() - z.real).abs() / unit).max().item(),
                       ((im_.double() - z.imag).abs() / unit).max().item())
            spectrum_ulps = max(spectrum_ulps, spec)
            check(spec <= K4_F64_ULPS, f"K4 two-level route's spectrum at n_fft {n_fft}: {spec} "
                  "ulps of the magnitude from float64")
            del re_, im_, z, unit
            row = k4_timing(x, x, n_fft, hop, events_ms, plain_reps=1 if plain else 0)
            _, m, clusters, _ = KS.bluestein_global_plan(n_fft)
            frames = S.num_frames(t + 2 * (n_fft // 2), n_fft, hop, center=False)
            transforms = b * ((frames + 1) // 2 if n_fft % 2 else frames)
            row.update({"M": m, "C": clusters, "S": m // clusters, "tile": KS.global_tile(clusters),
                        "transforms": transforms, "chunk": KS.global_chunk(transforms, m)})
            emit({"phase": "timing", "kernel": name, **row, "card": card})
            rows.append(row)
            pred = x + 0.05 * torch.randn(x.shape, device=dev, generator=gen)
            bank = SP.MultiResSTFTConfig(fft_sizes=(n_fft,))
            kernels.reset_launches()
            loss = SP.multi_res_stft_loss(pred, x, bank).item()
            torch.cuda.synchronize()
            got = dict(kernels.LAUNCHES)
            ref = SP.multi_res_stft_loss(pred, x, bank, stft=lambda a, n, h: k4_float64(
                a, n, h).float()).item()
            rel = abs(loss - ref) / abs(ref)
            losses.append({"n_fft": n_fft, "loss": loss, "float64_loss": ref, "rel_err": rel,
                           "launches": {k: v for k, v in got.items() if v}})
            check(got == {k: 2 * int(k == name) for k in got},
                  f"K4 two-level route's loss at n_fft {n_fft}: launches {got}")
            check(math.isfinite(loss) and rel <= LOSS_RTOL,
                  f"K4 two-level route's loss at n_fft {n_fft}: {loss} against {ref}")
            for k, v in got.items():
                launches[k] += v
            del x, pred
    emit({"phase": "kernel_check", "kernel": name, "what": "multi-resolution loss forward",
          "limit": LOSS_RTOL, "cases": losses})
    S._dft_basis_np.cache_clear()
    torch.cuda.empty_cache()
    first = rows[0]
    keys = ("n_fft", "hop", "B", "T", "M", "C", "S", "tile", "transforms", "chunk", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by")
    entry = {"name": name, "route": "cuda", "source": "nsc_tpu_torch/csrc/stft.cu",
             "replaces": "nsc_tpu/ops/pallas/stft.py:80",
             "kernels": [f"stft_magnitude_bluestein_global_{k}_kernel"
                         for k in ("cross_dif", "share", "cross_dit", "end")],
             "domain": "every n_fft no 8-block cluster holds (odd from 57,601, even from "
                       f"115,202), M up to {KS.GLOBAL_MAX_M}",
             "per": f"one launch (four kernels) at n_fft {first['n_fft']}, hop {first['hop']}, "
                    f"on {first['B']} x {first['T']}",
             "max_abs_err": err, "float64_max_ulps": f64,
             "spectrum_float64_max_ulps_of_magnitude": spectrum_ulps,
             "plain_float32_control": control,
             **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             "shapes": [{k: r[k] for k in keys} for r in rows]}
    return entry, launches


def k4_cluster_equal(dev, gen) -> None:
    """The cluster kernel against the one-block chirp-z kernel given the
    same M and pass list (`KS.bluestein_cluster_plan(n_fft, C)`, run by both
    through `KS.launch_chirp`) at K4_CLUSTER_EQUAL, magnitudes and spectrum:
    equal bit for bit (the same butterflies and twiddles per point)."""
    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.kernels import stft as KS

    rows = []
    for n_fft, c in K4_CLUSTER_EQUAL:
        x = torch.randn(3, 4 * n_fft + 37, device=dev, generator=gen) * 0.3
        plan = KS.bluestein_cluster_plan(n_fft, c)
        kernels.reset_launches()
        one = KS.launch_chirp(x, n_fft, n_fft // 4, (plan[0], plan[1], 1, plan[3]), spectrum=True)
        got = KS.launch_chirp(x, n_fft, n_fft // 4, plan, spectrum=True)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(one, got))
        launched = {k: kernels.LAUNCHES[k] for k in KS.COUNTERS.values() if kernels.LAUNCHES[k]}
        rows.append({"n_fft": n_fft, "C": c, "M": plan[1], "passes": list(plan[3]),
                     "bit_equal": equal, "launches": launched})
        check(equal, f"K4 cluster kernel at n_fft {n_fft}, C {c}: not the one-block kernel's values")
        check(launched == {"stft_magnitude_bluestein": 1, "stft_magnitude_bluestein_cluster": 1},
              f"K4 cluster equality at n_fft {n_fft}: launches {launched}")
    emit({"phase": "kernel_check", "kernel": "stft_magnitude_bluestein_cluster",
          "against": "stft_magnitude_bluestein at the same M and pass list", "cases": rows})


def k4_global_equal(dev, gen) -> None:
    """The two-level route against the one-block chirp-z kernel and against
    the cluster kernel given the same M and pass list
    (`KS.bluestein_global_plan(n_fft, C)`; `KS.launch_global` beside
    `KS.launch_chirp`) at K4_GLOBAL_EQUAL, magnitudes and spectrum: equal
    bit for bit (the same butterflies and twiddles per point)."""
    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.kernels import stft as KS

    rows = []
    for n_fft, c, other in K4_GLOBAL_EQUAL:
        x = torch.randn(3, 4 * n_fft + 37, device=dev, generator=gen) * 0.3
        plan = KS.bluestein_global_plan(n_fft, c)
        kernels.reset_launches()
        ref = KS.launch_chirp(x, n_fft, n_fft // 4, plan if other == "cluster" else (
            plan[0], plan[1], 1, plan[3]), spectrum=True)
        got = KS.launch_global(x, n_fft, n_fft // 4, plan, spectrum=True)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(ref, got))
        launched = {k: kernels.LAUNCHES[k] for k in KS.COUNTERS.values() if kernels.LAUNCHES[k]}
        rows.append({"n_fft": n_fft, "C": c, "against": other, "M": plan[1],
                     "passes": list(plan[3]), "bit_equal": equal, "launches": launched})
        check(equal, f"K4 two-level route at n_fft {n_fft}, C {c}: not the {other} kernel's values")
        want = "stft_magnitude_bluestein" + ("_cluster" if other == "cluster" else "")
        check(launched == {want: 1, "stft_magnitude_bluestein_global": 1},
              f"K4 two-level equality at n_fft {n_fft}: launches {launched}")
    emit({"phase": "kernel_check", "kernel": "stft_magnitude_bluestein_global",
          "against": "stft_magnitude_bluestein and stft_magnitude_bluestein_cluster at the same "
                     "M and pass list", "cases": rows})


def stage_list(cfg, t_len: int) -> list:
    """The 8 stages of `cfg`'s main path on t_len samples: per stage its
    name, part, index, the units' (C, T) and K5's input (C_in, T_in)."""
    from nsc_tpu_torch.models import seanet

    stages = []
    t = t_len
    for i, s in enumerate(cfg.strides):
        c = seanet.stage_widths(cfg)[i]
        inp = (c, t) if i == 0 else stages[-1]["units_ct"]
        stages.append({"name": f"enc{i}", "part": "encoder", "i": i, "units_ct": (c, t), "in_ct": inp})
        t //= s
    for i, s in enumerate(reversed(cfg.strides)):
        t *= s
        c = seanet.encoder_final_width(cfg) // 2 ** (i + 1)
        stages.append({"name": f"dec{i}", "part": "decoder", "i": i, "units_ct": (c, t), "in_ct": (c, t)})
    return stages


def k2_score_err(books, z, idx, best) -> dict:
    """K2's (or plain's) winning scores `best` against float64 scores of the
    same (frame, book, index): the float32 residual as the kernel forms it,
    the dot in float64; absolute errors and float32 ulps."""
    import torch

    from nsc_tpu_torch.kernels import rvq as KR

    csq = KR.codeword_sq_norms(books)
    r, errs, ulps, top = z, [], [], 0.0
    for q in range(books.shape[0]):
        i = idx[:, q].long()
        c = books[q][i]
        s64 = csq[q][i].double() - 2.0 * (r.double() * c.double()).sum(-1)
        e = (best[:, q].double() - s64).abs()
        errs.append(e)
        ulps.append(e / f32_ulp(s64))
        top = max(top, s64.abs().max().item())
        r = r - c
    e, u = torch.cat(errs), torch.cat(ulps)
    return {"max": e.max().item(), "mean": e.mean().item(), "max_abs_score": top,
            "max_ulps": u.max().item()}


def k2_bound(books, m: int):
    """K2's bound terms in ms on M frames: the bytes of the frames, the
    books and the indices, each once; its dot products as six bf16 MMAs
    each (the planes the kernel runs) at the bf16 tensor-core rate.
    Returns (bytes_ms, ops_ms)."""
    n_q, k, d = books.shape
    return ((m * d + books.numel() + m * n_q) * 4 / PEAK_BYTES * 1e3,
            6 * 2 * m * k * d * n_q / PEAK_BF16_FLOPS * 1e3)


def k3_bound(books, idx):
    """K3's bound terms in ms on indices `idx` (M, n_q): the indices, the
    codewords they read (each once) and the sums; one float32 add per
    element per book. Returns (bytes_ms, ops_ms)."""
    import torch

    (m, n_q), (k, d) = idx.shape, books.shape[1:]
    rows = torch.unique(idx.long() + torch.arange(n_q, device=idx.device)[None, :] * k).numel()
    return ((idx.numel() + rows * d + m * d) * 4 / PEAK_BYTES * 1e3,
            m * d * n_q / PEAK_F32_FLOPS * 1e3)


def k1_bound(x, p, dil, products: int = 1):
    """A stage kernel's bound terms in ms on its input x (B, C, T) and its
    weights p: the input read and the output written once, with the
    weights; `products` bf16 MMAs per unit product (K1 1, a float32-weight
    kernel 3) at the bf16 tensor-core rate. Returns (bytes_ms, ops_ms,
    unit_flops)."""
    b, c, t = x.shape
    unit_flops = 2 * b * t * len(dil) * 4 * c * c
    nbytes = 2 * x.numel() * x.element_size() + sum(v.numel() * v.element_size()
                                                     for v in p.values())
    return (nbytes / PEAK_BYTES * 1e3, products * unit_flops / PEAK_BF16_FLOPS * 1e3,
            unit_flops)


def train_smoke(dev, card, events_ms):
    """Phases 3-5 of the training path: stft_magnitude against its plain
    version and float64 on its four routes, the cluster kernel against the
    one-block chirp-z kernel and the two-level route against both, the C3
    gradient gate, the full-width training steps with the launch counters,
    the entry point with a resume, and the timings (the largest shapes' and
    the two-level route's first, with their checks). Returns the
    kernels-line entries of stft_magnitude (the FFT route),
    stft_magnitude_bluestein, stft_magnitude_bluestein_cluster and
    stft_magnitude_bluestein_global, the training path's launch counts, the
    step's ms and the two-level route's loss's launch counts."""
    import tempfile

    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.kernels import stft as KS
    from nsc_tpu_torch.losses import spectral as SP
    from nsc_tpu_torch.ops import stft as S
    from nsc_tpu_torch.ops.precision import float32_numerics
    from nsc_tpu_torch.train import checkpoint as ckpt
    from nsc_tpu_torch.train import data as data_lib
    from nsc_tpu_torch.train import loop as L
    from nsc_tpu_torch.train import train as T

    cfg, tcfg = get_config("base_fast"), TrainConfig()
    seg = L.segment_length(cfg, tcfg.segment_seconds)
    source = data_lib.make_source("synthetic", cfg.sample_rate, tcfg.seed)
    batches = [torch.from_numpy(next(source.batches(tcfg.batch_size, seg))).to(dev)
               for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    target = batches[0]

    def noisy(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return target + 0.05 * torch.randn(target.shape, device=dev, generator=g)

    pred = noisy(2)
    gen = torch.Generator(device=dev).manual_seed(3)

    # 3. stft_magnitude against its plain version and float64 ------------
    # the launch shapes of a step (the FFT route), of the shipped bank (five
    # resolutions and the mel STFT), of the k4_any, k4_chirp and k4_cluster
    # banks, each on the reconstruction and on the target; then the other
    # FFT-route shapes and the chirp-z routes', on the target (the
    # two-level route's: `k4_global_smoke`); each call with the counters
    # around it
    shapes = [(n, n // 4) for n in tcfg.stft_fft_sizes] + [(tcfg.mel_fft_size, tcfg.mel_fft_size // 4)]
    in_steps = set(shapes) | set(K4_ANY_SHAPES) | set(K4_CHIRP_SHAPES) | set(K4_CLUSTER_BANK_SHAPES)
    checked = dict.fromkeys(shapes + list(K4_ANY_SHAPES) + list(K4_CHIRP_SHAPES)
                            + list(K4_CLUSTER_BANK_SHAPES) + list(K4_MIXED_SHAPES)
                            + list(K4_BLUESTEIN_SHAPES) + list(K4_CLUSTER_SHAPES))
    k4_err = dict.fromkeys(KS.COUNTERS, 0.0)
    k4_f64 = dict.fromkeys(KS.COUNTERS, 0.0)  # max ulps; max error over the frame's peak
    t_checks = time.perf_counter()
    with torch.no_grad():
        # first the largest: the cluster route's shapes whose plain bases
        # were prefetched, checked and timed (`k4_rows`), then the two-level
        # route's (which drops the cached bases)
        k4_rows = {}
        for n_fft, hop in K4_CLUSTER_LARGE:
            kind, err, f64, _ = k4_check(target, n_fft, hop, "target")
            k4_err[kind] = max(k4_err[kind], err)
            k4_f64[kind] = max(k4_f64[kind], f64)
            k4_rows[n_fft, hop] = row = k4_timing(pred, target, n_fft, hop, events_ms)
            emit({"phase": "timing", "kernel": KS.COUNTERS[row["route"]], **row, "card": card})
        global_entry, global_launches = k4_global_smoke(dev, card, events_ms)
        emit({"phase": "timing", "what": "k4_large_shapes",
              "seconds": time.perf_counter() - t_checks})
        for n_fft, hop in checked:
            if (n_fft, hop) in k4_rows:
                continue
            inputs = (("pred", pred), ("target", target)) if (n_fft, hop) in in_steps else (
                ("target", target),)
            for what, x in inputs:
                kind, err, f64, _ = k4_check(x, n_fft, hop, what)
                k4_err[kind] = max(k4_err[kind], err)
                k4_f64[kind] = max(k4_f64[kind], f64)
        k4_cluster_equal(dev, gen)
        k4_global_equal(dev, gen)
    emit({"phase": "timing", "what": "k4_checks", "seconds": time.perf_counter() - t_checks})

    mrstft = SP.MultiResSTFTConfig(fft_sizes=tcfg.stft_fft_sizes)
    mrstft_any = SP.MultiResSTFTConfig(fft_sizes=K4_ANY_BANK)
    mrstft_chirp = SP.MultiResSTFTConfig(fft_sizes=K4_CHIRP_BANK)
    mrstft_cluster = SP.MultiResSTFTConfig(fft_sizes=K4_CLUSTER_BANK)
    losses = {
        "multi_res_stft": lambda p, st: SP.multi_res_stft_loss(p, target, mrstft, stft=st),
        "multi_res_stft_k4_any": lambda p, st: SP.multi_res_stft_loss(p, target, mrstft_any,
                                                                      stft=st),
        "multi_res_stft_k4_chirp": lambda p, st: SP.multi_res_stft_loss(p, target, mrstft_chirp,
                                                                        stft=st),
        "multi_res_stft_k4_cluster": lambda p, st: SP.multi_res_stft_loss(
            p, target, mrstft_cluster, stft=st),
        "mel": lambda p, st: SP.mel_loss(
            p, target, sample_rate=cfg.sample_rate, n_fft=tcfg.mel_fft_size,
            hop=tcfg.mel_fft_size // 4, n_mels=tcfg.mel_bins, stft=st),
    }
    routes = (("kernel", KS.stft_magnitude), ("plain", KS.stft_magnitude_plain),
              ("plain_rfft", lambda x, n_fft, hop: S.stft_magnitude(x, n_fft, hop)))

    def value_and_grad(fn, p, st):
        p = p.clone().requires_grad_(True)
        value = fn(p, st)
        (grad,) = torch.autograd.grad(value, p)
        return value.item(), grad

    # the mel loss on seed 2; the multi-resolution loss, on the shipped bank,
    # the k4_any, k4_chirp and k4_cluster banks, on every seed of K4_GRAD_SEEDS,
    # each gradient against the float64 one (max-abs figures printed, the
    # relative L2 distances gated)
    t_grad = time.perf_counter()
    for name, seeds in (("mel", (2,)), ("multi_res_stft", K4_GRAD_SEEDS),
                        ("multi_res_stft_k4_any", K4_GRAD_SEEDS),
                        ("multi_res_stft_k4_chirp", K4_GRAD_SEEDS),
                        ("multi_res_stft_k4_cluster", K4_GRAD_SEEDS)):
        fn = losses[name]
        for seed in seeds:
            p = pred if seed == 2 else noisy(seed)
            with float32_numerics():
                out = {route: value_and_grad(fn, p, st) for route, st in routes}
            (vk, gk), (vp, gp), (_, gr) = out["kernel"], out["plain"], out["plain_rfft"]
            rel = abs(vk - vp) / abs(vp)
            scale = gp.abs().max()
            grad_err = ((gk - gp).abs().max() / scale).item()
            floor = ((gr - gp).abs().max() / scale).item()
            rec = {"phase": "kernel_check", "kernel": "stft_magnitude", "loss": name,
                   "noise_seed": seed, "value_kernel": vk, "value_plain": vp,
                   "value_rel_err": rel, "grad_err_over_max": grad_err,
                   "plain_lowerings_grad_diff_over_max": floor}
            if name != "mel":
                _, g64 = value_and_grad(fn, p.double(), KS.stft_magnitude_plain)
                s64, n64 = g64.abs().max(), g64.norm()
                rec["grad_dist_to_float64_over_max"] = {
                    route: ((g.double() - g64).abs().max() / s64).item()
                    for route, (_, g) in out.items()}
                rec["grad_l2_dist_to_float64"] = l2 = {
                    route: ((g.double() - g64).norm() / n64).item() for route, (_, g) in out.items()}
                rec["kernel_over_plain_l2"] = l2["kernel"] / l2["plain"]
                del g64
            emit(rec)
            check(rel <= LOSS_RTOL, f"{name} loss through K4 (seed {seed}): rel err {rel}")
            if name == "mel":
                check(grad_err <= LOSS_GRAD_TOL[name],
                      f"{name} loss gradient through K4: {grad_err} (plain lowerings differ by {floor})")
            else:
                check(l2["kernel"] <= K4_F64_RATIO * l2["plain"],
                      f"{name} gradient through K4 farther from float64 than {K4_F64_RATIO} x the "
                      f"float32 plain path's at seed {seed}: {l2}")
                check(l2["kernel"] <= K4_F64_L2_TOL,
                      f"{name} gradient through K4 vs float64 at seed {seed}: {l2['kernel']}")
            del out, gk, gp, gr
            if p is not pred:
                del p
    emit({"phase": "timing", "what": "k4_gradient_gates", "seconds": time.perf_counter() - t_grad})

    # 4. training: the main path ------------------------------------------
    # PyTorch's default (TF32 convolutions allowed), as a user's process has
    # it: the train step and the data init turn TF32 off themselves
    torch.backends.cudnn.allow_tf32 = True
    tf32 = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    tf32_in_step = set()
    torch.cuda.reset_peak_memory_stats()
    model, state = T.init_train_state(cfg, tcfg, dev)
    step_fn = T.make_train_step(model, tcfg)
    before = {part: [x.detach().clone() for x in T.tree_leaves(state[part])]
              for part in ("params_g", "params_d")}
    kernels.reset_launches()
    L.data_init_codebooks(model, state, tcfg, "synthetic")
    init_books = state["rvq"]["codebooks"].clone()
    data_init_launches = dict(kernels.LAUNCHES)
    marks = ("generator", "discriminator", "updates")
    walls, event_ms, split = [], [], {m: [] for m in marks}
    metrics = {}
    for i, batch in enumerate(batches):
        timed = i >= TRAIN_WARMUP
        ev = {m: torch.cuda.Event(enable_timing=True) for m in ("start",) + marks}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev["start"].record()
        state, metrics = step_fn(state, batch,
                                 mark=lambda m: (ev[m].record(), tf32_in_step.add(tf32())))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        values = {k: float(v) for k, v in metrics.items()}
        emit({"phase": "main", "what": "train_step", "step": i + 1, "timed": timed,
              "wall_ms": wall * 1e3, **values})
        check(all(map(math.isfinite, values.values())), f"step {i + 1}: non-finite metric")
        check(0.0 <= values["rvq/reseed_frac"] <= 1.0, "rvq/reseed_frac out of [0, 1]")
        if timed:
            walls.append(wall)
            event_ms.append(ev["start"].elapsed_time(ev["updates"]))
            prev = "start"
            for m in marks:
                split[m].append(ev[prev].elapsed_time(ev[m]))
                prev = m
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(batches)
    changed = {part: sum(not torch.equal(a, b) for a, b in zip(before[part], T.tree_leaves(state[part])))
               for part in before}
    emit({"phase": "main", "what": "training", "config": cfg.name, "batch": tcfg.batch_size,
          "segment_samples": seg, "steps": n_steps, "launches": launches,
          "data_init_launches": data_init_launches,
          "leaves_changed": changed, "leaves": {p: len(v) for p, v in before.items()},
          "codebooks_moved": not torch.equal(init_books, state["rvq"]["codebooks"]),
          "tf32_inside_step": sorted(tf32_in_step),
          "peak_memory_bytes": peak})
    check(tf32_in_step == {(False, False)}, f"TF32 settings inside the step: {tf32_in_step}")
    check(tf32() == (True, False), f"TF32 settings after the steps: {tf32()}")
    for part, leaves in before.items():
        check(changed[part] == len(leaves), f"{part}: {len(leaves) - changed[part]} leaves unchanged")
    check(not torch.equal(init_books, state["rvq"]["codebooks"]), "EMA codebooks did not move")
    init_k2 = cfg.num_quantizers * 3  # per book: 2 Lloyd iterations + the final search
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"rvq_quantize": init_k2 + n_steps, "rvq_split_planes": init_k2 + n_steps,
                   "stft_magnitude": 12 * n_steps})
    # (the chirp-z routes and _dft stay 0: every training n_fft takes the FFT)
    check(data_init_launches["rvq_quantize"] == data_init_launches["rvq_split_planes"] == init_k2,
          f"data-init launches {data_init_launches}")
    check(launches == expect, f"training launch counts {launches}, expected {expect}")
    del state, before, init_books, metrics
    torch.cuda.empty_cache()

    # the entry point, with a resume
    with tempfile.TemporaryDirectory(prefix="nsc_train_") as wd:
        argv = ["--config", "base_fast", "--data", "synthetic", "--workdir", wd,
                "--batch-size", "16"]
        t0 = time.perf_counter()
        check(L.main(argv + ["--steps", "2"]) == 0, "entry point: 2 steps")
        train_dir = os.path.join(wd, "train")
        check(os.path.exists(os.path.join(wd, "metrics.jsonl")), "entry point: no metrics.jsonl")
        check(ckpt.latest_step(train_dir) == 2, "entry point: no checkpoint at step 2")
        check(L.main(argv + ["--steps", "3"]) == 0, "entry point: resume to 3")
        step, trees, _ = ckpt.restore(train_dir)
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        resumed = (step == 3 and trees["opt_g"]["count"] == 3 and trees["opt_d"]["count"] == 3
                   and [r["step"] for r in rows] == [2, 3])
        emit({"phase": "main", "what": "entry_point", "checkpoints": sorted(os.listdir(train_dir)),
              "metric_steps": [r["step"] for r in rows], "resumed_to": step,
              "finite": all(math.isfinite(v) for r in rows for v in r.values()),
              "seconds": time.perf_counter() - t0})
        check(resumed, "entry point: the second call did not resume from step 2")
        del trees

    # 5. timing -------------------------------------------------------------
    step_s = sum(walls) / len(walls)
    emit({"phase": "timing", "what": "train_step", "config": cfg.name,
          "batch": tcfg.batch_size, "segment_seconds": seg / cfg.sample_rate,
          "wall_ms": step_s * 1e3, "event_ms": sum(event_ms) / len(event_ms),
          "audio_seconds_per_second": tcfg.batch_size * seg / cfg.sample_rate / step_s,
          "split_ms": {m: sum(v) / len(v) for m, v in split.items()},
          "peak_memory_gb": peak / 1e9, "card": card})

    # K4 at the training shapes (bound: `k4_bound`), with the O(n^2) DFT's
    # operations (dft_ops_ms) printed as a yardstick of that algorithm. Per
    # step each training shape is launched on the reconstruction, keeping
    # the spectrum (`ms_spectrum`), and on the target (`ms`). K4's backward,
    # as the loss runs it (only the reconstruction's magnitudes take a
    # gradient), under the train step's float32 numerics:
    # `stft_magnitude_backward` on the kept spectrum; beside it the plain
    # matmul-DFT recompute that earlier versions of the port ran.
    def k4_recompute(x, n_fft, hop, grad):
        with torch.enable_grad(), float32_numerics():
            xx = x.detach().requires_grad_(True)
            y = KS.stft_magnitude_plain(xx, n_fft, hop)
            return torch.autograd.grad(y, xx, grad)

    k4 = dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "bound_ms",
                        "spectrum_bytes_ms", "f64_ops_ms", "dft_ops_ms", "backward_ms",
                        "recompute_backward_ms"), 0.0)
    b, t = target.shape
    with torch.no_grad():
        for n_fft, hop in shapes:
            win = S.hann_window(n_fft, dev)
            grad = torch.rand(b, 1 + t // hop, n_fft // 2 + 1, device=dev, generator=gen)
            mag, re_, im_ = KS.launch(pred, n_fft, hop, spectrum=True)
            with float32_numerics():
                bwd_ms = events_ms(lambda: KS.stft_magnitude_backward(
                    grad, re_, im_, mag, t, n_fft, hop), reps=3)
            rec_ms = events_ms(lambda: k4_recompute(pred, n_fft, hop, grad), reps=3)
            del grad, mag, re_, im_
            ms_spec = events_ms(lambda: KS.launch(pred, n_fft, hop, spectrum=True), reps=20)
            ms = events_ms(lambda: KS.stft_magnitude(target, n_fft, hop), reps=20)
            with float32_numerics():
                plain_ms = events_ms(lambda: KS.stft_magnitude_plain(target, n_fft, hop))
            lib_ms = events_ms(lambda: torch_stft_abs(target, n_fft, hop, win))
            flops, nbytes, bytes_ms, ops_ms, spec_bytes_ms, f64_ops_ms = k4_bound(b, t, n_fft, hop)
            dft_flops = 4 * b * (1 + t // hop) * n_fft * (n_fft // 2 + 1)
            dft_ops_ms = dft_flops / PEAK_F32_FLOPS * 1e3
            emit({"phase": "timing", "kernel": "stft_magnitude", "route": "fft", "n_fft": n_fft,
                  "hop": hop, "B": b, "T": t, "ms": ms, "ms_spectrum": ms_spec,
                  "backward_ms": bwd_ms, "recompute_backward_ms": rec_ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                  "spectrum_bytes_ms": spec_bytes_ms, "f64_ops_ms": f64_ops_ms,
                  "dft_flops": dft_flops, "dft_ops_ms": dft_ops_ms,
                  "achieved_bytes_per_s": nbytes / ms * 1e3})
            k4["ms"] += ms + ms_spec
            k4["backward_ms"] += bwd_ms
            k4["recompute_backward_ms"] += rec_ms
            k4["spectrum_bytes_ms"] += spec_bytes_ms
            k4["bound_ms"] += 2 * max(bytes_ms, ops_ms)
            for key, v in (("plain_ms", plain_ms), ("library_ms", lib_ms), ("bytes_ms", bytes_ms),
                           ("ops_ms", ops_ms), ("f64_ops_ms", f64_ops_ms),
                           ("dft_ops_ms", dft_ops_ms)):
                k4[key] += 2 * v
        emit({"phase": "timing", "kernel": "stft_magnitude",
              "per": "train step (12 forward launches, 6 backwards)", **k4, "card": card})
        # the other FFT-route shapes and the chirp-z routes' (the largest
        # were timed with their checks), one launch each
        for n_fft, hop in K4_MIXED_SHAPES + K4_BLUESTEIN_SHAPES + K4_CLUSTER_SHAPES:
            if (n_fft, hop) in k4_rows:
                continue
            k4_rows[n_fft, hop] = row = k4_timing(pred, target, n_fft, hop, events_ms)
            emit({"phase": "timing", "kernel": KS.COUNTERS[row["route"]], **row, "card": card})

        at_400 = k4_rows[400, 100]
        emit({"phase": "timing", "kernel": "stft_magnitude", "n_fft": 400, "hop": 100,
              "ms": at_400["ms"], "library_ms": at_400["library_ms"],
              "kernel_over_library": at_400["ms"] / at_400["library_ms"],
              "no_slower_than_library": at_400["ms"] <= at_400["library_ms"], "card": card})
    keys = ("n_fft", "hop", "B", "T", "ms", "plain_ms", "library_ms", "bound_ms")
    blu, clu = k4_rows[K4_BLUESTEIN_SHAPES[0]], k4_rows[K4_CLUSTER_SHAPES[0]]
    summaries = [
        {"name": "stft_magnitude", "route": "cuda", "source": "nsc_tpu_torch/csrc/stft.cu",
         "replaces": "nsc_tpu/ops/pallas/stft.py:80",
         "domain": f"even n_fft {KS.FFT_MIN}-{KS.FFT_MAX} whose half factors into 2, 3, 5, 7",
         "per": "train step (12 launches)", "max_abs_err": k4_err["fft"],
         "float64_max_ulps": k4_f64["fft"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": "bytes" if k4["bytes_ms"] > k4["ops_ms"] else "operations",
         "library_ms": k4["library_ms"],
         "shapes": [{k: r[k] for k in keys} for r in k4_rows.values() if r["route"] == "fft"]},
        {"name": "stft_magnitude_bluestein", "route": "cuda",
         "source": "nsc_tpu_torch/csrc/stft.cu", "replaces": "nsc_tpu/ops/pallas/stft.py:80",
         "domain": "every other n_fft >= 2 whose chirp-z length M (the smallest 7-smooth "
                   f">= 2L - 1) is at most {KS.BLUESTEIN_MAX_M}",
         "per": f"one launch at n_fft {blu['n_fft']}, hop {blu['hop']}",
         "max_abs_err": k4_err["bluestein"], "float64_max_ulps": k4_f64["bluestein"],
         **{k: blu[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "shapes": [{k: r[k] for k in keys} for r in k4_rows.values() if r["route"] == "bluestein"]},
        {"name": "stft_magnitude_bluestein_cluster", "route": "cuda",
         "source": "nsc_tpu_torch/csrc/stft.cu", "replaces": "nsc_tpu/ops/pallas/stft.py:80",
         "domain": "the chirp-z transform over a cluster of 2, 4 or 8 blocks: odd n_fft "
                   "7,205-57,599 and even ones 14,408-115,200 off the FFT route",
         "per": f"one launch at n_fft {clu['n_fft']}, hop {clu['hop']}",
         "max_abs_err": k4_err["bluestein_cluster"],
         "float64_max_ulps": k4_f64["bluestein_cluster"],
         **{k: clu[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "shapes": [{k: r[k] for k in keys} for r in k4_rows.values()
                    if r["route"] == "bluestein_cluster"]},
        global_entry,
    ]
    return summaries, launches, step_s * 1e3, global_launches


def k4_bank_smoke(dev, card, events_ms, phase, bank, mel) -> dict:
    """The k4_any and k4_chirp phases: base_fast trained at full width
    (batch 64 x 1 s, GAN on, seed 0) with the loss STFTs at `bank` (hop
    n/4) and the mel STFT at `mel` for K4_ANY_STEPS steps. Before each
    step, the same step with `stft=stft_magnitude_plain` from a copy of the
    state: the step's loss values within LOSS_RTOL of it. The counters
    around each step (K4 x2 per STFT, each on its route's counter; K2 +
    split x1), its time by CUDA events and the steps' peak memory; then
    each of the bank's launch shapes timed (`k4_timing`). Returns the
    steps' launch counts."""
    import copy

    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.kernels import stft as KS
    from nsc_tpu_torch.train import data as data_lib
    from nsc_tpu_torch.train import loop as L
    from nsc_tpu_torch.train import train as T

    cfg = get_config(FLAGSHIP)
    tcfg = TrainConfig(stft_fft_sizes=bank, mel_fft_size=mel)
    launch_shapes = tuple((n, n // 4) for n in bank + (mel,))
    routes = {n: KS.route(n) for n, _ in launch_shapes}
    check(all(routes[n] == K4_ROUTE.get(n, "fft") for n in routes), f"{phase}: routes {routes}")
    seg = L.segment_length(cfg, tcfg.segment_seconds)
    source = data_lib.make_source("synthetic", cfg.sample_rate, tcfg.seed)
    batches = [torch.from_numpy(next(source.batches(tcfg.batch_size, seg))).to(dev)
               for _ in range(K4_ANY_STEPS)]
    model, state = T.init_train_state(cfg, tcfg, dev)
    step_fn = T.make_train_step(model, tcfg)
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"rvq_quantize": 1, "rvq_split_planes": 1})
    for n, _ in launch_shapes:  # the reconstruction and the target
        expect[KS.COUNTERS[routes[n]]] += 2
    step_ms, peak = [], 0
    loss_keys = ("loss/stft", "loss/mel", "loss/g_total")
    for i, batch in enumerate(batches):
        kernels.reset_launches()
        with plain_stft():
            _, m_plain = step_fn(copy.deepcopy(state), batch)
        torch.cuda.synchronize()
        check(all(kernels.LAUNCHES[k] == 0 for k in KS.COUNTERS.values()),
              f"{phase}: the plain step launched K4 {kernels.LAUNCHES}")
        plain = {k: float(v) for k, v in m_plain.items()}
        del m_plain
        # (the plain step's blocks stay in the allocator's cache: emptied,
        # the timed step would pay for cudaMalloc again, ~0.4 s)
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kernels.reset_launches()
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = max(peak, torch.cuda.max_memory_allocated())
        step_ms.append(start.elapsed_time(end))
        values = {k: float(v) for k, v in metrics.items()}
        rel = {k: abs(values[k] - plain[k]) / abs(plain[k]) for k in loss_keys}
        emit({"phase": "main", "what": phase, "step": i + 1, "bank": list(bank),
              "mel_fft_size": mel, "launches": launches, "step_ms": step_ms[-1],
              "loss_rel_err_vs_plain_stft": rel, **values})
        check(all(map(math.isfinite, values.values())), f"{phase} step {i + 1}: non-finite metric")
        check(launches == expect, f"{phase} step {i + 1}: launches {launches}, expected {expect}")
        check(max(rel.values()) <= LOSS_RTOL,
              f"{phase} step {i + 1}: losses {rel} from the plain STFT's")
        for k, n in launches.items():
            total[k] += n
    del state, metrics, batches
    torch.cuda.empty_cache()
    # K4's launches of a step, each shape on the reconstruction (keeping the
    # spectrum) and on the target
    target = torch.from_numpy(next(source.batches(tcfg.batch_size, seg))).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    pred = target + 0.05 * torch.randn(target.shape, device=dev, generator=g)
    k4_ms, bound_ms = 0.0, 0.0
    with torch.no_grad():
        for n_fft, hop in launch_shapes:
            row = k4_timing(pred, target, n_fft, hop, events_ms)
            emit({"phase": "timing", "kernel": KS.COUNTERS[row["route"]], "bank": phase, **row,
                  "card": card})
            k4_ms += row["ms"] + row["ms_spectrum"]
            bound_ms += 2 * row["bound_ms"]
    emit({"phase": "timing", "what": f"{phase}_step", "config": cfg.name, "batch": tcfg.batch_size,
          "bank": list(bank), "mel_fft_size": mel, "step_event_ms": step_ms,
          "peak_memory_gb": peak / 1e9, "k4_ms_per_step": k4_ms, "k4_bound_ms_per_step": bound_ms,
          "card": card})
    return total


def first_flips(idx, ref_idx, ref_margins) -> dict:
    """Indices against a reference: how many differ, and the reference
    margin at each differing frame's first differing book (later books
    follow the first flip). `ok`: every such margin is below K2_NEAR_TIE."""
    import numpy as np

    n_q = ref_idx.shape[-1]
    diff = (idx != ref_idx).reshape(-1, n_q)
    margins = np.asarray(ref_margins).reshape(-1, n_q)
    frames = np.nonzero(diff.any(-1))[0]
    first = diff[frames].argmax(-1)
    m = margins[frames, first]
    return {"index_mismatches": int(diff.sum()), "frames_differing": int(frames.size),
            "frames": int(diff.shape[0]), "first_flip_margins": sorted(float(v) for v in m)[:64],
            "ok": bool((m < K2_NEAR_TIE).all())}


def index_check(books, z, idx_k, idx_p) -> dict:
    """K2's indices against the plain version's: how many differ, and
    whether each frame's first difference is at a near-tie (the plain
    version's margin there below K2_NEAR_TIE)."""
    import torch

    from nsc_tpu_torch.ops import rvq as rvq_ops
    from nsc_tpu_torch.ops.precision import float32_numerics

    diff = idx_k != idx_p
    bad = diff.any(dim=1).nonzero().flatten()
    near, worst = 0, 0.0
    if bad.numel():
        with float32_numerics():
            margins = rvq_ops.argmin_margins({"codebooks": books}, z[bad])
        first = diff[bad].int().argmax(dim=1)
        m_first = margins[torch.arange(bad.numel(), device=z.device), first]
        near = int((m_first < K2_NEAR_TIE).sum().item())
        worst = m_first.max().item()
    return {"index_mismatches": int(diff.sum().item()), "frames_differing": int(bad.numel()),
            "near_ties": near, "worst_first_mismatch_margin": worst}


def hold_quantize(books, z, idx_k, what: str):
    """K2's indices `idx_k` on (books, z) against the plain version's,
    gated by the near-tie rule. Returns (the record, the plain indices)."""
    from nsc_tpu_torch.kernels import rvq as KR
    from nsc_tpu_torch.ops.precision import float32_numerics

    with float32_numerics():
        idx_p = KR.quantize_plain(books, z)
    rec = index_check(books, z, idx_k, idx_p)
    check(rec["near_ties"] == rec["frames_differing"],
          f"K2 {what}: an index differs where the plain version's margin is not a near-tie")
    return rec, idx_p


# The refit's k-means searches (one book each) run book 0 on the trained
# encoder's raw latents, whose norms reach ~130 on synthetic2, so a score
# ||c||^2 - 2 r.c reaches ~-1e4, where one float32 ulp is ~1e-3 and plain's
# own margins are off from float64 by about as much (readings in PERF.md,
# from this script and scripts/torch_refit_flips.py). A refit flip is
# allowed where plain's margin is below K2_NEAR_TIE (the flagship check's
# rule), or where K2's pick scores within K2_NEAR_TIE of the float64 best of
# the book (plain, not K2, missed the argmin). Any other flip is a K2 error.
def hold_refit_search(books, z, idx_k) -> dict:
    """K2's indices on one refit search (books (1, K, D), residuals z)
    against the plain version's and, past the margin rule, against the
    float64 scores of the whole book."""
    import torch

    from nsc_tpu_torch.kernels import rvq as KR
    from nsc_tpu_torch.ops import rvq as rvq_ops
    from nsc_tpu_torch.ops.precision import float32_numerics

    check(books.shape[0] == 1, f"refit search over {books.shape[0]} books")
    with float32_numerics():
        idx_p = KR.quantize_plain(books, z)
    rec = index_check(books, z, idx_k, idx_p)
    rec.update(past_near_tie=[], k2_errors=0)
    if rec["near_ties"] == rec["frames_differing"]:
        return rec
    bad = (idx_k != idx_p).any(dim=1).nonzero().flatten()
    with float32_numerics():
        margin = rvq_ops.argmin_margins({"codebooks": books}, z[bad])[:, 0]
    past = bad[margin >= K2_NEAR_TIE]
    cb, r = books[0].double(), z[past].double()
    s64 = (cb * cb).sum(1)[None, :] - 2 * (r @ cb.t())
    best = s64.min(dim=1).values
    rows = torch.arange(past.numel(), device=z.device)
    k2_gap = s64[rows, idx_k[past, 0].long()] - best
    plain_gap = s64[rows, idx_p[past, 0].long()] - best
    for j, m in enumerate(margin[margin >= K2_NEAR_TIE].tolist()):
        rec["past_near_tie"].append({
            "margin": m, "float64_best_score": best[j].item(), "k2_minus_best": k2_gap[j].item(),
            "plain_minus_best": plain_gap[j].item(), "r_norm": r[j].norm().item()})
    rec["k2_errors"] = int((k2_gap >= K2_NEAR_TIE).sum().item())
    return rec


@contextlib.contextmanager
def recording(module, names):
    """Record the arguments and result of every call to `module.<name>` for
    each name while the block runs (the calls themselves are unchanged:
    the path's own launches), and restore the functions after it."""
    calls = {name: [] for name in names}
    originals = {name: getattr(module, name) for name in names}

    def recorder(name, fn):
        def call(*args):
            out = fn(*args)
            calls[name].append((args, out))
            return out
        return call

    for name, fn in originals.items():
        setattr(module, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def hold_dispatches(calls, what: str) -> dict:
    """Each recorded K2 call against the plain version (near-tie rule) and
    each recorded K3 call against the plain version (bit-exact): the
    streaming path's own launches, at its own shapes."""
    import torch

    from nsc_tpu_torch.kernels import rvq as KR
    from nsc_tpu_torch.ops.precision import float32_numerics

    q = {"M": [], "index_mismatches": 0, "frames_differing": 0, "near_ties": 0,
         "worst_first_mismatch_margin": 0.0}
    for (books, z), idx in calls["quantize"]:
        rec = hold_quantize(books, z, idx, f"{what} dispatch M={z.shape[0]}")[0]
        q["M"].append(z.shape[0])
        for key in ("index_mismatches", "frames_differing", "near_ties"):
            q[key] += rec[key]
        q["worst_first_mismatch_margin"] = max(q["worst_first_mismatch_margin"],
                                               rec["worst_first_mismatch_margin"])
    dq = {"M": [], "bit_exact": True, "max_abs_err": 0.0}
    for (books, idx), out in calls["dequantize"]:
        with float32_numerics():
            ref = KR.dequantize_plain(books, idx)
        dq["M"].append(idx.shape[0])
        dq["bit_exact"] &= bool(torch.equal(out, ref))
        dq["max_abs_err"] = max(dq["max_abs_err"], (out - ref).abs().max().item())
    check(dq["bit_exact"], f"K3 {what}: a dispatch is not bit-exact against its plain version")
    return {"rvq_quantize": q, "rvq_dequantize": dq}


def flagship_smoke(dev, wav_np):
    """The trained flagship from its export: the serving bundle's
    reconstruct with its launch counts, the float32 path against nsc_tpu's
    CPU float32 reference on both probes, the serving path run to run and
    against its GPU pin, K2 against its plain version on the serving
    latents of the batch, and serving against float32 on the trained books
    (with the units op by op beside K1). Returns (serving bundle, float32
    bundle, the reconstruct's launches)."""
    import dataclasses

    import numpy as np
    import torch

    from nsc_tpu_torch import api, canonical, kernels
    from nsc_tpu_torch.ops import rvq as rvq_ops
    from nsc_tpu_torch.train import checkpoint as ckpt

    meta = ckpt.export_meta(EXPORT)
    t0 = time.perf_counter()
    serve = api.load_model(FLAGSHIP, checkpoint=EXPORT, serving=True, device=dev)
    load_s = time.perf_counter() - t0
    f32 = api.load_model(FLAGSHIP, checkpoint=EXPORT, device=dev)
    cfg = serve.cfg
    fps = (api.codebook_fingerprint(serve.rvq), api.codebook_fingerprint(f32.rvq))
    emit({"phase": "flagship", "what": "load", "export": os.path.relpath(EXPORT), "meta": meta,
          "fingerprints": fps, "load_seconds": load_s, "route": serve.model.kernels.units,
          "devices": sorted({str(t.device) for t in (serve.rvq["codebooks"], f32.rvq["codebooks"])})})
    check(fps == (meta["fingerprint"], meta["fingerprint"]), f"flagship fingerprint {fps} != {meta}")
    check(serve.model.kernels.units == "residual_stack" and serve.model.kernels.rvq,
          f"flagship serving kernels {serve.model.kernels}")

    # the main path on trained weights: reconstruct, counters around it
    wav = torch.from_numpy(wav_np).to(dev)
    kernels.reset_launches()
    out = serve.model.reconstruct(serve.params, serve.rvq, wav)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"residual_stack": 8, "rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1})
    emit({"phase": "flagship", "what": "reconstruct", "shape": list(out.shape),
          "finite": bool(torch.isfinite(out).all().item()), "launches": launches})
    check(tuple(out.shape) == tuple(wav.shape) and torch.isfinite(out).all().item(),
          "flagship reconstruct output")
    check(launches == expect, f"flagship launch counts {launches}, expected {expect}")
    del out

    # the float32 path against nsc_tpu's CPU float32 reference
    probes = {"noise": canonical.probe_input(cfg), "speech": canonical.speech_probe_input(cfg)}
    with np.load(os.path.join(EXPORT, "reference_f32.npz"), allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    check(int(ref["fingerprint"]) == meta["fingerprint"], "reference_f32.npz: other codebooks")
    for name, x in probes.items():
        rec = first_flips(api.encode(f32, x), ref[f"indices_{name}"], ref[f"margins_{name}"])
        emit({"phase": "flagship", "what": "float32_vs_nsc_tpu_cpu_reference", "probe": name,
              "rows": x.shape[0], "seconds": x.shape[1] / cfg.sample_rate, **rec})
        check(rec["ok"], f"flagship float32 {name} probe: an index differs from nsc_tpu's "
              f"where its margin is not below {K2_NEAR_TIE}")

    # the serving path: run to run, and against the GPU pin
    first = api.encode(serve, probes["speech"])
    again = api.encode(serve, probes["speech"])
    exact, rate, status, gated = canonical.check_pin(serve, EXPORT)
    emit({"phase": "flagship", "what": "serving_determinism", "run_to_run_equal":
          bool(np.array_equal(first, again)), "pin_exact": exact, "pin_match_rate": rate,
          "pin_status": status, "backend": canonical.backend(dev), "pin_gated": gated})
    check(np.array_equal(first, again), "flagship serving path: two encodes of the probe differ")
    check(exact is not None, f"flagship GPU pin: {status}")
    if gated:
        check(exact, f"flagship serving path misses its GPU pin: {rate} ({status})")

    # the main path's K2 on the trained books: the serving bundle's own
    # latents of the 64 x 10 s batch, against the plain version (gated)
    from nsc_tpu_torch.kernels import rvq as KR

    books = serve.rvq["codebooks"].contiguous()
    z = serve.model.latents(serve.params, wav).reshape(-1, books.shape[-1]).float().contiguous()
    rec = hold_quantize(books, z, KR.quantize(books, z), "flagship batch 64 x 10 s")[0]
    emit({"phase": "kernel_check", "kernel": "rvq_quantize", "on": "flagship serving latents",
          "M": z.shape[0], **rec})
    del z

    # serving against float32 on the trained books (reported), with the
    # serving config's units op by op ("reference" route: bf16, no K1) as
    # the witness that tells bf16's own error from K1's: latents as
    # ||a - b|| / ||b||, indices as the share of equal entries
    units_off = api.bundle_from_jax(dataclasses.replace(cfg, unit_backend="reference"),
                                    *ckpt.restore_inference(EXPORT), device=dev)
    check(units_off.model.kernels.units == "reference", f"units off: {units_off.model.kernels}")

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    for name, x_np in (("batch_64x10s", wav_np), ("speech_probe", probes["speech"])):
        x = torch.from_numpy(x_np).to(dev)
        lat = {"float32": f32.model.latents(f32.params, x),
               "serving_k1": serve.model.latents(serve.params, x),
               "serving_units_op_by_op": units_off.model.latents(units_off.params, x)}
        idx = {k: rvq_ops.quantize(f32.rvq, v, kernel=False) for k, v in lat.items()}
        margins = rvq_ops.argmin_margins(f32.rvq, lat["float32"]).flatten().double()
        idx_s = serve.model.encode(serve.params, serve.rvq, x)
        idx_f = idx["float32"]
        dec_f = f32.model.decode(f32.params, f32.rvq, idx_f)
        dec_s = serve.model.decode(serve.params, serve.rvq, idx_f)
        ref_rms = dec_f.pow(2).mean().sqrt().item()
        pairs = (("serving_k1", "float32"), ("serving_units_op_by_op", "float32"),
                 ("serving_k1", "serving_units_op_by_op"))
        emit({"phase": "flagship", "what": "serving_vs_float32", "input": name,
              "index_agreement": (idx_s == idx_f).float().mean().item(),
              "latent_rel_err": {f"{a}_vs_{b}": rel(lat[a], lat[b]) for a, b in pairs},
              "plain_quantize_index_agreement": {
                  f"{a}_vs_{b}": (idx[a] == idx[b]).float().mean().item() for a, b in pairs},
              "decode_only_max_abs": (dec_s - dec_f).abs().max().item(),
              "decode_only_rel_rms": (dec_s - dec_f).pow(2).mean().sqrt().item() / max(ref_rms, 1e-12),
              "float32_argmin_margin_percentiles": {
                  p: torch.quantile(margins, p / 100).item() for p in (0, 1, 5, 50)},
              "float32_margins_below_near_tie": (margins < K2_NEAR_TIE).double().mean().item()})
        del x, lat, idx, idx_f, idx_s, dec_f, dec_s, margins
    del units_off
    return serve, f32, launches


def streaming_smoke(serve, f32, card, events_ms):
    """Streaming on the flagship: 30 s of the speech probe in 1 s chunks,
    against batch compress/decompress on both bundles, push_many against
    sequential pushes, the serving bundle's launch counts per dispatch and
    the streaming real-time factors. Returns the streaming launches."""
    import numpy as np
    import torch

    from nsc_tpu_torch import api, bitstream, canonical, kernels, streaming
    from nsc_tpu_torch.ops import rvq as rvq_ops

    cfg = serve.cfg
    wav = canonical.speech_probe_input(cfg, STREAM_ROWS).reshape(-1)
    seconds = wav.shape[0] / cfg.sample_rate
    chunk = int(STREAM_CHUNK_SECONDS * cfg.sample_rate)
    batch_idx = {}
    for name, b in (("float32", f32), ("serving", serve)):
        blob = api.compress(b, wav)
        sblob = api.streaming_compress(b, wav, chunk_seconds=STREAM_CHUNK_SECONDS)
        idx_b = bitstream.deserialize(blob)[1]
        idx_s = bitstream.deserialize(sblob)[1]
        # the reference margins: the batch path's own latents
        lat = b.model.latents(b.params, torch.from_numpy(wav[None]).to(b.device))
        margins = rvq_ops.argmin_margins(b.rvq, lat)[0].cpu().numpy()
        rec = first_flips(idx_s, idx_b, margins)
        batch_idx[name] = idx_b
        if name == "serving":
            rec["index_agreement_with_float32_batch"] = {
                "streaming": float((idx_s == batch_idx["float32"]).mean()),
                "batch": float((idx_b == batch_idx["float32"]).mean())}
        batch_wav = api.decompress(b, blob)
        stream_wav = api.streaming_decompress(b, blob, chunk_seconds=STREAM_CHUNK_SECONDS)
        finite = bool(np.isfinite(stream_wav).all())
        emit({"phase": "streaming", "what": "streaming_vs_batch", "bundle": name,
              "seconds": seconds, "chunk_seconds": STREAM_CHUNK_SECONDS,
              "bytes_identical": sblob == blob, **rec,
              "decompress_shape": [list(batch_wav.shape), list(stream_wav.shape)],
              "decompress_finite": finite,
              "decompress_max_abs_diff": float(np.abs(stream_wav - batch_wav).max())})
        if name == "float32":
            check(rec["ok"], "flagship float32 streaming: an index differs from batch where "
                  f"its margin is not below {K2_NEAR_TIE}")
        check(stream_wav.shape == batch_wav.shape == wav.shape and finite,
              f"{name} streaming_decompress: shape or finiteness")
        del lat

    # push_many against sequential pushes on the serving bundle
    chunks = [wav[i:i + chunk] for i in range(0, 4 * chunk, chunk)]
    seq_enc = streaming.StreamingEncoder(serve.model, serve.params, serve.rvq)
    seq = [seq_enc.push(c) for c in chunks]
    many = streaming.StreamingEncoder(serve.model, serve.params, serve.rvq).push_many(chunks)
    equal = all(np.array_equal(a, c) for a, c in zip(many, seq))
    emit({"phase": "streaming", "what": "push_many_vs_push", "bundle": "serving",
          "chunks": len(chunks), "identical": equal,
          "index_mismatches": int(sum((a != c).sum() for a, c in zip(many, seq)))})
    check(equal, "serving push_many differs from sequential pushes")

    # launch counts: one K2 (with its split) per encoder dispatch, one K3 per
    # decoder dispatch, no stage kernel (the units run op by op); and each
    # dispatch's K2 and K3 against their plain versions on the dispatch's
    # own inputs (queue 4: 200 frames, and a 100-frame tail; queue 1: 50)
    from nsc_tpu_torch.kernels import rvq as KR

    dispatch_inputs = {}
    for queue in (4, 1):
        with recording(KR, ("quantize", "dequantize")) as calls:
            kernels.reset_launches()
            sblob = api.streaming_compress(serve, wav, chunk_seconds=STREAM_CHUNK_SECONDS,
                                           queue_chunks=queue)
            api.streaming_decompress(serve, sblob, chunk_seconds=STREAM_CHUNK_SECONDS,
                                     queue_chunks=queue)
            torch.cuda.synchronize()
            counted = dict(kernels.LAUNCHES)
        if queue == 4:
            launches = counted
        dispatches = -(-math.ceil(seconds / STREAM_CHUNK_SECONDS) // queue)
        expect = dict.fromkeys(kernels.LAUNCHES, 0)
        expect.update({"rvq_quantize": dispatches, "rvq_split_planes": dispatches,
                       "rvq_dequantize": dispatches})
        held = hold_dispatches(calls, f"streaming queue {queue}")
        emit({"phase": "streaming", "what": "launches", "queue_chunks": queue,
              "dispatches_each_way": dispatches, "launches": counted})
        emit({"phase": "kernel_check", "on": "streaming dispatches", "queue_chunks": queue, **held})
        check(counted == expect, f"streaming launch counts at queue {queue}: {counted}, "
              f"expected {expect}")
        (books, z), idx = calls["quantize"][0]
        dispatch_inputs[queue] = (books, z, idx)
        del calls

    # real-time factors on the serving bundle, host clock (each call ends
    # with its indices or samples on the host)
    for queue_chunks in (4, 1):
        times = {}
        for what in ("streaming_compress", "streaming_decompress"):
            fn = (lambda: api.streaming_compress(serve, wav, STREAM_CHUNK_SECONDS, queue_chunks=queue_chunks)
                  ) if what == "streaming_compress" else (
                lambda: api.streaming_decompress(serve, sblob, STREAM_CHUNK_SECONDS, queue_chunks=queue_chunks))
            fn()
            torch.cuda.synchronize()
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            times[what] = (time.perf_counter() - t0) / reps
        emit({"phase": "timing", "what": "streaming", "bundle": "serving", "queue_chunks": queue_chunks,
              "seconds": seconds, "chunk_seconds": STREAM_CHUNK_SECONDS,
              **{f"{k}_wall_ms": v * 1e3 for k, v in times.items()},
              **{f"{k}_rtf": seconds / v for k, v in times.items()}, "card": card})

    # K2 and K3 on one dispatch's own inputs at each queue (200 and 50
    # frames), beside their plain versions and bounds (as the serving
    # shape's), in turns (kernel, plain, plain, kernel): the plain times at
    # these shapes swing between runs
    for queue, (books, z, idx) in dispatch_inputs.items():
        m = z.shape[0]
        q_bytes_ms, q_ops_ms = k2_bound(books, m)
        dq_bytes_ms, dq_ops_ms = k3_bound(books, idx)
        rec = {}
        for name, kern, plain in (
                ("quantize", lambda: KR.quantize(books, z), lambda: KR.quantize_plain(books, z)),
                ("dequantize", lambda: KR.dequantize(books, idx), lambda: KR.dequantize_plain(books, idx))):
            turns = [events_ms(fn, reps=20) for fn in (kern, plain, plain, kern)]
            rec[f"{name}_ms"] = (turns[0] + turns[3]) / 2
            rec[f"{name}_plain_ms"] = (turns[1] + turns[2]) / 2
            rec[f"{name}_turns_ms"] = turns
        emit({"phase": "timing", "kernel": "rvq", "shape": "one streaming dispatch",
              "queue_chunks": queue, "M": m, **rec,
              "quantize_bound_ms": max(q_bytes_ms, q_ops_ms),
              "dequantize_bound_ms": max(dq_bytes_ms, dq_ops_ms), "card": card})
    return launches


def run_cli(*args, phase="cli") -> str:
    """`python3 -m nsc_tpu_torch ARGS` in a fresh process from the repo's
    root: its rc, wall seconds and output tails printed, rc 0 gated.
    Returns its stdout."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nsc_tpu_torch", *args], cwd=root,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    emit({"phase": phase, "args": [os.path.relpath(a, root) if a.startswith(root) else a
                                   for a in args],
          "rc": proc.returncode, "wall_seconds": wall,
          "stdout_tail": proc.stdout[-400:], "stderr_tail": proc.stderr[-400:]})
    check(proc.returncode == 0, f"CLI {args[0]}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def cli_smoke(serve, qserve):
    """`python3 -m nsc_tpu_torch` in subprocesses on a 10 s WAV of the
    speech probe: compress (batch and streaming) of the serving bundle, each
    stream's indices against the same encode in this process; decompress
    against the same decompress in this process; eval --ceiling --json.
    (`info` and the other commands are covered by the CPU tests: each call
    here costs 10-16 s of process start.)"""
    import tempfile

    import numpy as np

    from nsc_tpu_torch import api, bitstream, canonical
    from nsc_tpu_torch.utils import audio

    model = ["--model", FLAGSHIP, "--checkpoint", EXPORT, "--serving"]
    with tempfile.TemporaryDirectory(prefix="nsc_cli_") as tmp:
        wav_path = os.path.join(tmp, "speech.wav")
        audio.save_wav(wav_path, canonical.speech_probe_input(serve.cfg, 1)[0], serve.cfg.sample_rate)
        wav, _ = audio.load_wav(wav_path, target_sr=serve.cfg.sample_rate)
        run = run_cli
        batch_path, stream_path = os.path.join(tmp, "batch.nsc"), os.path.join(tmp, "stream.nsc")
        run("compress", wav_path, batch_path, *model)
        run("compress", wav_path, stream_path, "--streaming", "1.0", *model)
        for path, want in ((batch_path, api.encode(serve, wav)),
                           (stream_path, bitstream.deserialize(api.streaming_compress(serve, wav, 1.0))[1])):
            with open(path, "rb") as f:
                got = bitstream.deserialize(f.read())[1]
            equal = bool(np.array_equal(got, want))
            emit({"phase": "cli", "what": "stream_indices_vs_in_process", "stream": os.path.basename(path),
                  "shape": list(got.shape), "equal": equal})
            check(equal, f"CLI {os.path.basename(path)}: indices differ from the in-process encode")
        out_path, want_path = os.path.join(tmp, "out.wav"), os.path.join(tmp, "want.wav")
        run("decompress", batch_path, out_path, *model)
        with open(batch_path, "rb") as f:
            audio.save_wav(want_path, api.decompress(serve, f.read()), serve.cfg.sample_rate)
        got, want = audio.load_wav(out_path)[0], audio.load_wav(want_path)[0]
        equal = got.shape == want.shape == wav.shape and bool(np.array_equal(got, want))
        emit({"phase": "cli", "what": "decompress_vs_in_process", "samples": got.shape[0], "equal": equal})
        check(equal, "CLI decompress: the WAV differs from the in-process decompress")
        # --int8: the stream and the decoded WAV of the int8 serving bundle
        # (quantize_model's default calibration) against the same calls here
        int8_path, int8_wav = os.path.join(tmp, "int8.nsc"), os.path.join(tmp, "int8.wav")
        run("compress", wav_path, int8_path, *model, "--int8")
        run("decompress", int8_path, int8_wav, *model, "--int8")
        blob = api.compress(qserve, wav)
        with open(int8_path, "rb") as f:
            same_stream = f.read() == blob
        audio.save_wav(want_path, api.decompress(qserve, blob), serve.cfg.sample_rate)
        got, want = audio.load_wav(int8_wav)[0], audio.load_wav(want_path)[0]
        same_wav = got.shape == want.shape and bool(np.array_equal(got, want))
        emit({"phase": "cli", "what": "int8_vs_in_process", "stream_equal": same_stream,
              "wav_equal": same_wav})
        check(same_stream and same_wav, "CLI --int8: the stream or the WAV differs from the "
              "in-process calls")
        metrics = json.loads(run("eval", wav_path, "--ceiling", "--json", *model).strip().splitlines()[-1])
        emit({"phase": "cli", "what": "eval", "metrics": metrics})
        check(all(math.isfinite(v) for v in metrics.values() if isinstance(v, float)),
              f"CLI eval: non-finite metric {metrics}")
        check("ceiling_mel_distance" in metrics and "stoi" in metrics, f"CLI eval: metrics {metrics}")


def deterministic():
    """PyTorch's deterministic algorithms (warnings, not errors, where an op
    has none) and cuDNN's deterministic convolutions while the block runs, so
    that two training runs can be compared bit for bit; the caller's
    settings come back after it (`loop.deterministic_algorithms`, which
    `--deterministic` turns on)."""
    from nsc_tpu_torch.train.loop import deterministic_algorithms

    return deterministic_algorithms()


@contextlib.contextmanager
def recording_states(full_at):
    """Host copies of the live train state after each step of the loop's
    train step (`seen[step]`): params_g and the codebooks, and the whole
    state at the steps in `full_at`. Wraps `loop.make_train_step` while the
    block runs; the step itself is unchanged."""
    import torch

    from nsc_tpu_torch import weights
    from nsc_tpu_torch.train import loop as L

    seen, make = {}, L.make_train_step

    def factory(model, tcfg):
        step_fn = make(model, tcfg)

        def wrapped(state, batch, **kw):
            state, metrics = step_fn(state, batch, **kw)
            keep = state if state["step"] in full_at else {
                "params_g": state["params_g"], "rvq": {"codebooks": state["rvq"]["codebooks"]}}
            seen[state["step"]] = weights.tree_map(
                lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, keep)
            return state, metrics
        return wrapped

    L.make_train_step = factory
    try:
        yield seen
    finally:
        L.make_train_step = make


def trees_equal(a, b) -> bool:
    """Two trees of tensors and numbers (as the train state), leaf for leaf,
    bit for bit."""
    import torch

    from nsc_tpu_torch.train.train import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def export_equals(step_dir: str, params_g, rvq) -> bool:
    """The export's weights.npz against (params_g, rvq), array for array, bit
    for bit."""
    import numpy as np

    from nsc_tpu_torch.train import checkpoint as ckpt

    want = ckpt.export_arrays(params_g, rvq)
    with np.load(os.path.join(step_dir, ckpt.EXPORT_WEIGHTS)) as z:
        return sorted(z.files) == sorted(want) and all(
            np.array_equal(z[k], want[k]) for k in want)


def serve_workdir(dev, workdir: str, wav, what: str) -> dict:
    """`load_model(checkpoint=<workdir>, serving=True)` and reconstruct of the
    64 x 10 s batch with the counters around it (K1 x8, K2 and its split x1,
    K3 x1). Returns the launches."""
    import torch

    from nsc_tpu_torch import api, kernels
    from nsc_tpu_torch.train import checkpoint as ckpt

    serve = api.load_model(ckpt.export_meta(workdir)["config"], checkpoint=workdir,
                           serving=True, device=dev)
    kernels.reset_launches()
    out = serve.model.reconstruct(serve.params, serve.rvq, wav)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"residual_stack": 8, "rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1})
    finite = bool(torch.isfinite(out).all().item())
    emit({"phase": what, "what": "serve_workdir", "export": os.path.relpath(
        ckpt.resolve_export(workdir), workdir), "shape": list(out.shape), "finite": finite,
        "launches": launches})
    check(tuple(out.shape) == tuple(wav.shape) and finite, f"{what}: reconstruct output")
    check(launches == expect, f"{what}: serving launch counts {launches}, expected {expect}")
    return launches


def loop_smoke(dev, wav, tmp, step_ms, card):
    """The training entry point at full width (base_fast, batch 64 x 1 s)
    on a WAV directory and on a pool of synthetic2: eviction and the
    full/inference cadence, best.json, a resume against an uninterrupted
    run (metrics rows bit for bit, both under `deterministic()`), the
    threaded snapshot against a synchronous save of the live state, the
    launches per step, and serving the trained workdir. Returns the
    launches of the training runs and of the serving reconstruct."""
    import numpy as np
    import torch

    from nsc_tpu_torch import api, canonical, kernels
    from nsc_tpu_torch.train import checkpoint as ckpt
    from nsc_tpu_torch.train import data as data_lib
    from nsc_tpu_torch.train import loop as L
    from nsc_tpu_torch.train import train as T
    from nsc_tpu_torch.utils import audio

    argv = ["--config", FLAGSHIP, "--checkpoint-every", "1", "--full-state-every", "2", *LOOP_ARGS]
    cfg, tcfg, _ = L.parse_args(argv)
    sr, seg = cfg.sample_rate, L.segment_length(cfg, tcfg.segment_seconds)
    # the WAV directory: synthetic2 rows of 3 s, the speech probe's first
    # row, and its second row at 22.05 kHz in stereo (resample, mono)
    wav_dir = os.path.join(tmp, "wavs")
    os.makedirs(wav_dir)
    for i, row in enumerate(next(data_lib.make_source("synthetic2", sr, 11).batches(6, 3 * sr))):
        audio.save_wav(os.path.join(wav_dir, f"synthetic2_{i}.wav"), row, sr)
    speech = canonical.speech_probe_input(cfg, 2)
    audio.save_wav(os.path.join(wav_dir, "speech_0.wav"), speech[0], sr)
    other = audio.resample(speech[1], sr, 22_050)
    audio.save_wav(os.path.join(wav_dir, "speech_1_stereo_22k.wav"),
                   np.stack([other, 0.5 * other], axis=1), 22_050)
    pool_spec = f"synthetic2:pool={LOOP_POOL}"

    # host sources: seconds per batch of 64 x 1 s (the pool's build apart)
    host = {}
    for name, spec in (("wav_directory", wav_dir), ("synthetic2", "synthetic2"),
                       ("synthetic2_pool", pool_spec)):
        t0 = time.perf_counter()
        it = data_lib.make_source(spec, sr, 0).batches(tcfg.batch_size, seg)
        next(it)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(SOURCE_BATCHES):
            next(it)
        host[name] = {"first_batch_seconds": first,
                      "seconds_per_batch": (time.perf_counter() - t0) / SOURCE_BATCHES}
    emit({"phase": "loop", "what": "host_sources", "batch": tcfg.batch_size, "segment_samples": seg,
          **host, "train_step_ms": step_ms, "card": card})

    # the threaded snapshot's cost to the step: windows of SNAPSHOT_WINDOW
    # steps without a snapshot and with one submitted after the first step
    # (its write a torch.save of the host copy, overlapping the next steps),
    # in turns whose order alternates; the writer is joined after each
    # snapshot window, outside the window's time. The cost is the mean
    # difference of the windows, resolved where it exceeds twice its
    # standard error.
    model, state = T.init_train_state(cfg, tcfg, dev)
    step_fn = T.make_train_step(model, tcfg)
    batch = torch.from_numpy(next(data_lib.make_source(pool_spec, sr, 0).batches(
        tcfg.batch_size, seg))).to(dev)
    writer, writes, joins = L.SnapshotWriter(dev), [], []

    def write(host):
        t0 = time.perf_counter()
        torch.save(host, os.path.join(tmp, "snapshot.pt"))
        writes.append(time.perf_counter() - t0)

    state, _ = step_fn(state, batch)
    walls = {"plain": [], "snapshot": []}
    for turn in range(SNAPSHOT_TURNS):
        for mode in (("plain", "snapshot") if turn % 2 == 0 else ("snapshot", "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(SNAPSHOT_WINDOW):
                state, metrics = step_fn(state, batch)
                if mode == "snapshot" and i == 0:
                    writer.submit(state, write)
            float(metrics["loss/g_total"])
            walls[mode].append(time.perf_counter() - t0)
            if mode == "snapshot":
                t0 = time.perf_counter()
                writer.join()
                joins.append(time.perf_counter() - t0)
    p_w, s_w = np.array(walls["plain"]), np.array(walls["snapshot"])
    cost = float(s_w.mean() - p_w.mean())
    cost_se = float(math.sqrt(p_w.var(ddof=1) / p_w.size + s_w.var(ddof=1) / s_w.size))
    emit({"phase": "loop", "what": "snapshot_cost", "window_steps": SNAPSHOT_WINDOW,
          "window_wall_seconds": walls, "join_wait_seconds": joins, "torch_save_seconds": writes,
          "cost_seconds": cost, "cost_standard_error": cost_se,
          "resolved": abs(cost) > 2 * cost_se,
          "full_state_values": sum(x.numel() for x in T.tree_leaves(state)
                                   if isinstance(x, torch.Tensor)), "card": card})
    del model, state, step_fn, batch, writer
    torch.cuda.empty_cache()

    full_steps = [1, 3, LOOP_STEPS]  # the first boundary, then every 2 since the last full save
    launches_all = dict.fromkeys(kernels.LAUNCHES, 0)

    def rows(wd):
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            out = [json.loads(line) for line in f]
        return out

    def call(wd, spec, steps):
        # the entry point's arguments; LOOP_KEEP full states kept and a
        # metrics row per step, which the CLI does not set
        _, tcfg_run, kwargs = L.parse_args(argv + ["--data", spec, "--workdir", wd,
                                                   "--steps", str(steps)])
        tcfg_run = dataclasses.replace(tcfg_run, keep_checkpoints=LOOP_KEEP, log_every=1)
        kernels.reset_launches()
        t0 = time.perf_counter()
        L.run(cfg, tcfg_run, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        for k, v in got.items():
            launches_all[k] += v
        return got, seconds

    served = None
    for name, spec in (("wav_directory", wav_dir), ("synthetic2_pool", pool_spec)):
        wd_a, wd_b = os.path.join(tmp, f"{name}_a"), os.path.join(tmp, f"{name}_b")
        with deterministic():
            with recording_states(full_at={3}) as live:
                got_a, sec_a = call(wd_a, spec, LOOP_STEPS)
            got_b1, sec_b1 = call(wd_b, spec, 3)
            got_b2, sec_b2 = call(wd_b, spec, LOOP_STEPS)
        init_k2 = cfg.num_quantizers * 3
        for got, steps, init in ((got_a, LOOP_STEPS, True), (got_b1, 3, True),
                                 (got_b2, LOOP_STEPS - 3, False)):
            expect = dict.fromkeys(kernels.LAUNCHES, 0)
            k2 = steps + (init_k2 if init else 0)
            expect.update({"rvq_quantize": k2, "rvq_split_planes": k2, "stft_magnitude": 12 * steps})
            check(got == expect, f"loop {name}: launches {got}, expected {expect}")
        train_a, train_b = os.path.join(wd_a, "train"), os.path.join(wd_b, "train")
        kept = ckpt.kept_steps(full_steps, LOOP_KEEP)
        infer_kept = list(range(LOOP_STEPS - ckpt.INFER_KEEP + 1, LOOP_STEPS + 1))
        steps_seen = {"train_a": ckpt.all_steps(train_a), "train_b": ckpt.all_steps(train_b),
                      "infer_a": ckpt.export_steps(os.path.join(wd_a, "infer")),
                      "infer_b": ckpt.export_steps(os.path.join(wd_b, "infer")),
                      "infer_best_a": ckpt.export_steps(os.path.join(wd_a, "infer_best"))}
        with open(os.path.join(wd_a, "best.json")) as f:
            best = json.load(f)
        ra, rb = rows(wd_a), rows(wd_b)
        walls = [1.0 / r.pop("steps_per_sec") for r in ra]
        for r in rb:
            r.pop("steps_per_sec")
        differ = [(x["step"], k) for x, y in zip(ra, rb) for k in x if x[k] != y.get(k)]
        # the threaded snapshot of step 3 against a synchronous save of the
        # live state at step 3; and run B's step 3, its final (inline) save
        sync_path = os.path.join(tmp, f"{name}_sync_3.pt")
        torch.save(live[3], sync_path)
        async_blob = torch.load(ckpt.path_for(train_a, 3), map_location="cpu", weights_only=True)
        sync_state = torch.load(sync_path, map_location="cpu", weights_only=True)
        async_equal = trees_equal(async_blob["state"], sync_state)
        b3_equal = trees_equal(async_blob["state"], torch.load(
            ckpt.path_for(train_b, 3), map_location="cpu", weights_only=True)["state"]) if 3 in \
            steps_seen["train_b"] else None
        final = live[LOOP_STEPS]
        best_equal = export_equals(os.path.join(wd_a, "infer_best", str(best["step"])),
                                   live[best["step"]]["params_g"], live[best["step"]]["rvq"])
        infer_equal = export_equals(os.path.join(wd_a, "infer", str(LOOP_STEPS)),
                                    final["params_g"], final["rvq"])
        emit({"phase": "loop", "what": "entry_point", "data": name, "steps": steps_seen,
              "expected_train": kept, "expected_infer": infer_kept, "best": best,
              "rows_equal": not differ and len(ra) == len(rb) == LOOP_STEPS,
              "rows_differing": differ[:20], "row_wall_seconds": walls,
              "async_snapshot_equals_sync_save": async_equal,
              "resumed_run_step3_equals_async_step3": b3_equal,
              "infer_best_equals_live_state": best_equal, "infer_equals_final_state": infer_equal,
              "full_state_bytes": os.path.getsize(ckpt.path_for(train_a, LOOP_STEPS)),
              "export_bytes": os.path.getsize(os.path.join(wd_a, "infer", str(LOOP_STEPS),
                                                           ckpt.EXPORT_WEIGHTS)),
              "seconds": {"a": sec_a, "b": sec_b1, "b_resume": sec_b2},
              "launches": {"a": got_a, "b": got_b1, "b_resume": got_b2}})
        check(steps_seen["train_a"] == steps_seen["train_b"] == kept,
              f"loop {name}: full states {steps_seen}, expected {kept}")
        check(steps_seen["infer_a"] == steps_seen["infer_b"] == infer_kept,
              f"loop {name}: exports {steps_seen}, expected {infer_kept}")
        check(math.isfinite(best["value"]) and 1 <= best["step"] <= LOOP_STEPS
              and steps_seen["infer_best_a"][-1] == best["step"], f"loop {name}: best.json {best}")
        check(not differ and len(ra) == len(rb) == LOOP_STEPS,
              f"loop {name}: the resumed run's metrics rows differ: {differ[:20]}")
        check(async_equal, f"loop {name}: the threaded step-3 snapshot differs from a synchronous save")
        check(best_equal, f"loop {name}: infer_best/{best['step']} differs from the live state")
        check(infer_equal, f"loop {name}: infer/{LOOP_STEPS} differs from the final state")
        if served is None:
            # the float32 bundle of infer/ against the final live state, and
            # the serving bundle of the workdir (infer_best)
            f32 = api.load_model(FLAGSHIP, checkpoint=os.path.join(wd_a, "infer"), device=dev)
            mine = api.bundle_from_jax(cfg, final["params_g"], final["rvq"], device=dev)
            probe = canonical.speech_probe_input(cfg, 2)
            idx_equal = bool(np.array_equal(api.encode(f32, probe), api.encode(mine, probe)))
            emit({"phase": "loop", "what": "float32_bundle_vs_final_state", "rows": 2,
                  "indices_equal": idx_equal})
            check(idx_equal, f"loop {name}: the float32 bundle's indices differ from the final state's")
            del f32, mine
            served = serve_workdir(dev, wd_a, wav, "loop")
        del live, final, async_blob, sync_state
        torch.cuda.empty_cache()
    return launches_all, served


def refit_smoke(dev, card):
    """The flagship's codebook refit, once per seed of REFIT_SEEDS: latents
    of synthetic2 batches through the float32 bundle, refit_codebooks
    (k-means 10) between two pool_reports, the residual MSE falling at
    every depth, every K2 search of the refit against quantize_plain and,
    past the near-tie rule, against float64 (`hold_refit_search`: 0 K2
    errors), and the launch counts. Returns the launches of all seeds."""
    import numpy as np
    import torch

    from nsc_tpu_torch import api, kernels
    from nsc_tpu_torch.kernels import rvq as KR
    from nsc_tpu_torch.train import data as data_lib
    from nsc_tpu_torch.train import refit

    f32 = api.load_model(FLAGSHIP, checkpoint=EXPORT, device=dev)
    cfg = f32.cfg
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    for seed in REFIT_SEEDS:
        t0 = time.perf_counter()
        batches = data_lib.make_source("synthetic2", cfg.sample_rate, seed).batches(
            REFIT_BATCH, cfg.sample_rate)
        pool = refit.collect_latents(f32, batches, REFIT_BATCHES)
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        kernels.reset_launches()
        t0 = time.perf_counter()
        before = refit.pool_report(f32.rvq, pool)
        with recording(KR, ("quantize",)) as calls:
            new = refit.refit_codebooks(f32.rvq, pool, kmeans_iters=REFIT_ITERS, seed=seed)
        after = refit.pool_report(new, pool)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n_q = cfg.num_quantizers
        searches = n_q * (REFIT_ITERS + 1)
        expect = dict.fromkeys(kernels.LAUNCHES, 0)
        expect.update({"rvq_quantize": searches + 2, "rvq_split_planes": searches + 2})
        flips = {"searches": len(calls["quantize"]), "frames": 0, "index_mismatches": 0,
                 "frames_differing": 0, "near_ties": 0, "k2_errors": 0,
                 "worst_first_mismatch_margin": 0.0, "past_near_tie": []}
        for (books, z), idx in calls["quantize"]:
            rec = hold_refit_search(books, z, idx)
            flips["frames"] += z.shape[0]
            for key in ("index_mismatches", "frames_differing", "near_ties", "k2_errors"):
                flips[key] += rec[key]
            flips["worst_first_mismatch_margin"] = max(flips["worst_first_mismatch_margin"],
                                                       rec["worst_first_mismatch_margin"])
            flips["past_near_tie"] += rec["past_near_tie"]
        del calls
        emit({"phase": "refit", "seed": seed, "frames": int(pool.shape[0]),
              "kmeans_iters": REFIT_ITERS, "before": before, "after": after,
              "collect_seconds": collect_s, "refit_seconds": refit_s, "launches": launches,
              "card": card})
        emit({"phase": "kernel_check", "kernel": "rvq_quantize", "on": "the refit's k-means "
              "searches (trained flagship books)", "seed": seed, **flips})
        check(pool.shape[0] >= 25_000, f"refit: {pool.shape[0]} frames")
        check(all(a < b for a, b in zip(after["residual_mse_per_depth"],
                                         before["residual_mse_per_depth"])),
              f"refit seed {seed}: residual MSE did not fall at every depth: {before} -> {after}")
        check(flips["k2_errors"] == 0, f"K2 refit search, seed {seed}: an index differs where "
              f"the plain version's margin is not below {K2_NEAR_TIE} and K2's pick is not "
              f"within it of the float64 best: {flips['past_near_tie'][:8]}")
        check(flips["searches"] == searches,
              f"refit: {flips['searches']} K2 searches, expected {searches}")
        check(launches == expect, f"refit: launches {launches}, expected {expect}")
        check(bool(np.isfinite(new["codebooks"].cpu().numpy()).all()), "refit: non-finite codebooks")
        for key, n in launches.items():
            total[key] += n
        del pool, new
    del f32
    return total


def finetune_smoke(dev, wav, tmp, card):
    """run_finetune on the flagship's export at full width (batch 64 x 1 s,
    synthetic2 pool, 4 steps, held-out eval every 2): the encoder and the
    codebooks bit for bit unchanged, only decoder leaves moved, the launch
    counts, and serving the finetuned workdir. Returns (the finetune's
    launches, the serving launches)."""
    import dataclasses

    import numpy as np
    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.train import checkpoint as ckpt
    from nsc_tpu_torch.train import finetune

    wd = os.path.join(tmp, "finetune")
    tcfg = dataclasses.replace(finetune.finetune_config(FINETUNE_STEPS, batch_size=64),
                               **FINETUNE_OVERRIDES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, meta = finetune.run_finetune(EXPORT, workdir=wd, steps=FINETUNE_STEPS, tcfg=tcfg,
                                      data_spec=f"synthetic2:pool={LOOP_POOL}", eval_every=2,
                                      device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # per step the frozen forward's K2 (+ split) and the losses' 12 STFTs;
    # once, the held-out batch's frozen forward (its mel is the plain one)
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"rvq_quantize": FINETUNE_STEPS + 1, "rvq_split_planes": FINETUNE_STEPS + 1,
                   "stft_magnitude": 12 * FINETUNE_STEPS})
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        held = [json.loads(line) for line in f if "heldout/mel" in line]
    final = os.path.join(wd, "infer", str(FINETUNE_STEPS))
    with np.load(os.path.join(EXPORT, ckpt.EXPORT_WEIGHTS)) as a, \
            np.load(os.path.join(final, ckpt.EXPORT_WEIGHTS)) as b:
        same_keys = sorted(a.files) == sorted(b.files)
        moved = sorted(k for k in a.files if not np.array_equal(a[k], b[k]))
    emit({"phase": "finetune", "steps": FINETUNE_STEPS, "batch": tcfg.batch_size,
          "heldout_mel": [(r["step"], r["heldout/mel"]) for r in held], "out": out,
          "leaves_moved": len(moved), "moved_outside_decoder": [k for k in moved
                                                                if not k.startswith("params/decoder/")],
          "infer_best": ckpt.export_steps(os.path.join(wd, "infer_best")),
          "seconds": seconds, "launches": launches, "card": card})
    check(same_keys and moved and all(k.startswith("params/decoder/") for k in moved),
          f"finetune: leaves moved outside the decoder or none moved: {moved[:8]}")
    check(all(math.isfinite(r["heldout/mel"]) for r in held) and len(held) == FINETUNE_STEPS // 2,
          f"finetune: held-out rows {held}")
    check(launches == expect, f"finetune: launches {launches}, expected {expect}")
    return launches, serve_workdir(dev, wd, wav, "finetune")



def close_smoke(dev, wav, tmp, card):
    """The run-closing tools on the card: base_fast trained at full width
    (batch 64 x 1 s, GAN on) by `python -m nsc_tpu_torch.train` under the
    watchdog (`train/watchdog.py`: 1 s poll, CLOSE_GRACE_S and
    CLOSE_STALE_S above the whole run), an export every step and a full
    state every 2, with the harvester (`train/harvest.py`, 0.2 s poll,
    watching this process's PID so that it outlives the relaunch) on a
    thread; SIGKILLed once, after its CLOSE_KILL_AT export appears. Gated:
    one restart, the run complete with rc 0 and resumed from the newest full
    state at the kill, harvest/ 1..CLOSE_STEPS each with its sha256,
    infer/ the newest 3, no *.tmp under train/, infer/ or infer_best/, and
    the relaunched trainer's launches (K2 + split x1 and K4 x12 a step).
    Then, on the card: the held-out trend over every harvested step (every
    row finite; a second call adds none; K1 x16, K2 + split x2, K3 x2 a
    step), the smoothed winner and `pick_export_step` (K1 x12, K2 + split
    x1, K3 x2 a candidate), the winner's export with its GPU pin (the
    re-check exact on this backend; K1 x16, K2 + split x4), and the export
    served (`serve_workdir`). Returns (the launches of the trend, pick,
    export and serving, the relaunched trainer's)."""
    import signal
    import threading

    import torch

    from nsc_tpu_torch import canonical, kernels
    from nsc_tpu_torch.configs import get_config
    from nsc_tpu_torch.eval import heldout
    from nsc_tpu_torch.train import checkpoint as ckpt
    from nsc_tpu_torch.train import export, harvest, watchdog

    run = os.path.join(tmp, "close_run")
    pid_file, stop_file = os.path.join(tmp, "train.pid"), os.path.join(tmp, "train_stop")
    watch_pid, counts = os.path.join(tmp, "watch.pid"), os.path.join(tmp, "trainer_launches")
    with open(watch_pid, "w") as f:
        f.write(f"{os.getpid()}\n")
    harvested, harvest_log, kill = [], [], {}

    def tmp_files():
        return sorted(os.path.relpath(os.path.join(d, n), run)
                      for sub in ("train", "infer", "infer_best")
                      for d, ds, fs in os.walk(os.path.join(run, sub)) for n in ds + fs
                      if n.endswith(".tmp"))

    done = threading.Event()

    def read_pid():
        with open(pid_file) as f:
            text = f.read().strip()
        return int(text) if text else None

    def kill_once():
        """SIGKILL the trainer once its CLOSE_KILL_AT export appears; time
        the watchdog's relaunch; end supervision (the stop file) at a second
        relaunch or past CLOSE_GRACE_S, so that a failing run fails fast."""
        deadline = time.time() + CLOSE_GRACE_S
        while not os.path.isdir(os.path.join(run, "infer", str(CLOSE_KILL_AT))):
            if time.time() > deadline or done.is_set():
                open(stop_file, "w").close()
                return
            time.sleep(0.02)
        pid = read_pid()
        full = ckpt.all_steps(os.path.join(run, "train"))
        os.kill(pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        kill.update(pid=pid, full_states=full, tmp_at_kill=tmp_files(), t=t_kill)
        seen = {pid}
        while not done.wait(0.01):
            now = read_pid()  # None while the watchdog rewrites the file
            if now is not None and now not in seen:
                seen.add(now)
                kill.setdefault("relaunch_seconds", time.perf_counter() - t_kill)
            if len(seen) > 2 or time.time() > deadline:
                kill["stopped"] = f"{len(seen) - 1} relaunches" if len(seen) > 2 else "deadline"
                open(stop_file, "w").close()
                return

    hv = threading.Thread(target=lambda: harvested.extend(harvest.harvest(
        run, watch_pid, poll=0.2, log=harvest_log.append)), daemon=True)
    kt = threading.Thread(target=kill_once, daemon=True)
    args = ["--config", FLAGSHIP, "--data", "synthetic2", "--steps", str(CLOSE_STEPS),
            "--checkpoint-every", "1", "--full-state-every", "2", *CLOSE_ARGS]
    t0 = time.perf_counter()
    hv.start()
    kt.start()
    res = watchdog.supervise(run, args, command=[sys.executable, "-c", COUNTING_TRAINER, counts],
                             poll=1.0, grace_s=CLOSE_GRACE_S, stale_s=CLOSE_STALE_S,
                             wedge_backoff_s=1.0, pid_file=pid_file, stop_file=stop_file)
    if res.status != "complete":
        res.proc.kill()
    rc = res.proc.wait(CLOSE_STALE_S)  # found complete by its last row: the final save follows
    t_end = time.perf_counter()
    done.set()
    os.remove(watch_pid)  # the harvester's final sweep
    hv.join(120)
    kt.join(10)
    with open(run + ".log") as f:
        log = f.read()
    resumed = re.findall(r"resumed from step (\d+)", log)
    full_at_kill = kill.get("full_states") or [None]
    hdir = os.path.join(run, "harvest")
    steps_h = sorted(int(n) for n in os.listdir(hdir) if n.isdigit())
    sha_ok = {}
    for s in steps_h:
        with open(os.path.join(hdir, str(s), ckpt.EXPORT_META)) as f:
            want = json.load(f)["weights_sha256"]
        sha_ok[s] = ckpt._sha256(os.path.join(hdir, str(s), ckpt.EXPORT_WEIGHTS)) == want
    left = tmp_files()
    infer_steps = ckpt.export_steps(os.path.join(run, "infer"))
    files = sorted(n for n in os.listdir(tmp) if n.startswith(os.path.basename(counts) + "."))
    trainers = []
    for n in files:
        with open(os.path.join(tmp, n)) as f:
            trainers.append(json.load(f))
    k = int(resumed[-1]) if resumed else None
    expect_train = dict.fromkeys(kernels.LAUNCHES, 0)
    if k is not None:
        n_run = CLOSE_STEPS - k
        expect_train.update({"rvq_quantize": n_run, "rvq_split_planes": n_run,
                             "stft_magnitude": 12 * n_run})
    emit({"phase": "close", "what": "watchdog", "status": res.status, "restarts": res.restarts,
          "rc": rc, "events": [e.split(" ", 2)[2] for e in res.events],
          "killed_pid": kill.get("pid"), "stopped": kill.get("stopped"),
          "full_states_at_kill": full_at_kill,
          "tmp_at_kill": kill.get("tmp_at_kill"), "resumed_from": resumed,
          "harvested": steps_h, "harvest_sha_ok": sha_ok, "harvest_lines": len(harvest_log),
          "infer": infer_steps, "tmp_left": left, "trainer_launches": trainers,
          "expected_trainer_launches": expect_train, "train_seconds": t_end - t0,
          "relaunch_seconds": kill.get("relaunch_seconds"),
          "resumed_run_seconds": t_end - kill["t"] - kill.get("relaunch_seconds", 0.0)
          if "t" in kill else None, "card": card})
    check(res.status == "complete" and res.restarts == 1 and rc == 0 and "pid" in kill,
          f"close: the watchdog saw {res.status} after {res.restarts} restarts, rc {rc}")
    check(resumed == [str(full_at_kill[-1])],
          f"close: resumed from {resumed}, the newest full state at the kill was {full_at_kill}")
    check(steps_h == list(range(1, CLOSE_STEPS + 1)) and all(sha_ok.values()),
          f"close: harvest holds {steps_h} (sha256 {sha_ok})")
    check(infer_steps == list(range(CLOSE_STEPS - ckpt.INFER_KEEP + 1, CLOSE_STEPS + 1)),
          f"close: infer/ holds {infer_steps}")
    check(left == [], f"close: left after the relaunch: {left}")
    check(trainers == [expect_train],
          f"close: the relaunched trainer's launches {trainers}, expected {expect_train}")

    # the held-out trend on the card, the winner, the pick, the export
    def counted(fn):
        kernels.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, dict(kernels.LAUNCHES)

    def per(n, **each):
        out = dict.fromkeys(kernels.LAUNCHES, 0)
        out.update({key: n * v for key, v in each.items()})
        return out

    lines = []
    trend_kw = dict(config=FLAGSHIP, data="synthetic2", device=dev, log=lines.append, **CLOSE_TREND)
    rows, trend_s, trend_l = counted(lambda: heldout.heldout_trend(run, **trend_kw))
    path = os.path.join(run, heldout.TREND_FILE)
    with open(path) as f:
        before = f.read()
    again = heldout.heldout_trend(run, **trend_kw)
    with open(path) as f:
        after = f.read()
    here = canonical.backend(dev)
    fields = ("mel_short", "si_snr_short", "usage", "mel_10s", "si_snr_10s")
    st = len(get_config(FLAGSHIP).strides)  # K1 launches per encode or decode
    expect_trend = per(len(rows), residual_stack=4 * st, rvq_quantize=2, rvq_split_planes=2,
                       rvq_dequantize=2)
    emit({"phase": "close", "what": "heldout_trend", "rows": rows, "second_call_rows": len(again),
          "seconds": trend_s, "seconds_per_step": trend_s / max(len(rows), 1),
          "launches": trend_l, "card": card})
    check([r["step"] for r in rows] == steps_h and all(
        math.isfinite(r[key]) for r in rows for key in fields) and all(
        r["backend"] == here for r in rows), f"close: trend rows {rows}")
    check(again == [] and before == after, "close: the second trend call appended rows")
    check(trend_l == expect_trend, f"close: trend launches {trend_l}, expected {expect_trend}")

    winner, smoothed = heldout.smoothed_winner(heldout.load_rows(path))
    cands = {ckpt.export_steps(os.path.join(run, sub))[-1] for sub in ("infer", "infer_best")}
    picked, pick_s, pick_l = counted(lambda: heldout.pick_export_step(
        run, config=FLAGSHIP, data="synthetic2", device=dev, log=lines.append))
    expect_pick = per(len(cands), residual_stack=3 * st, rvq_quantize=1, rvq_split_planes=1,
                      rvq_dequantize=2)
    emit({"phase": "close", "what": "selection", "smoothed_winner": winner["step"],
          "smoothed_mel_short": smoothed, "raw_best": min(rows, key=lambda r: r["mel_short"])["step"],
          "pick_candidates": sorted(cands), "pick_recommends": picked,
          "pick_table": [ln for ln in lines if "@" in ln], "pick_seconds": pick_s,
          "launches": pick_l, "card": card})
    check(picked in cands, f"close: pick_export_step recommends {picked} of {sorted(cands)}")
    check(pick_l == expect_pick, f"close: pick launches {pick_l}, expected {expect_pick}")

    dest = os.path.join(tmp, "exports", f"close_{winner['step']}")
    out, export_s, export_l = counted(lambda: export.export_flagship(
        run, os.path.basename(dest), step=winner["step"], data="synthetic2", segment_len=17600,
        dest=dest, device=dev, log=lines.append))
    pin = out["check"]
    expect_export = per(4, residual_stack=st, rvq_quantize=1, rvq_split_planes=1)
    emit({"phase": "close", "what": "export", "step": out["step"],
          "source": os.path.relpath(export.select_step(run, winner["step"], lambda _: None), run),
          "meta": out["meta"], "pin_exact": pin.exact, "pin_rate": pin.match_rate,
          "pin_same_backend": pin.same_backend, "pin_status": pin.status,
          "seconds": export_s, "launches": export_l, "card": card})
    check(pin.exact is True and pin.same_backend and out["step"] == winner["step"],
          f"close: the export's pin re-check {pin}")
    check(export_l == expect_export, f"close: export launches {export_l}, expected {expect_export}")
    served = serve_workdir(dev, dest, wav, "close")
    launches = {key: trend_l[key] + pick_l[key] + export_l[key] + served[key] for key in trend_l}
    emit({"phase": "timing", "what": "close", "train_under_watchdog_seconds": t_end - t0,
          "relaunch_seconds": kill.get("relaunch_seconds"), "trend_seconds": trend_s,
          "trend_seconds_per_step": trend_s / max(len(rows), 1), "pick_seconds": pick_s,
          "export_and_pin_seconds": export_s, "card": card})
    return launches, trainers[0]

def drift(idx_a, idx_b, dec_a, dec_b) -> dict:
    """Index agreement of two paths, and the divergence of their decodes of
    the same indices."""
    ref_rms = dec_b.pow(2).mean().sqrt().item()
    return {"index_agreement": (idx_a == idx_b).float().mean().item(),
            "decode_only_max_abs": (dec_a - dec_b).abs().max().item(),
            "decode_only_rel_rms": ((dec_a - dec_b).pow(2).mean().sqrt().item()
                                    / max(ref_rms, 1e-12))}


def reconstruct_rtf(b, wav, reps=3) -> dict:
    """Wall time and real-time factor of `b`'s reconstruct of `wav` (after
    one warm call), host clock to a synchronize, mean of `reps`."""
    import torch

    b.model.reconstruct(b.params, b.rvq, wav)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        b.model.reconstruct(b.params, b.rvq, wav)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    seconds = wav.shape[0] * wav.shape[1] / b.cfg.sample_rate
    return {"wall_ms": wall * 1e3, "rtf": seconds / wall}


def int8_product_shapes(dev, bundle, wav, events_ms, plain: bool) -> dict:
    """The int8 product of every conv site of `bundle` (an int8 bundle) on
    `wav`: one reconstruct, with the route's calls recorded by shape
    (kind, x8, w8, stride, dilation) and counted. For each distinct shape:
    the route's time, its bound (bytes: codes read once, int32 sums written
    once, at the HBM rate; operations: the MACs at the int8 tensor-core
    rate), and with `plain` its plain version's time and whether the two
    agree bit for bit. Returns the per-shape records and per-reconstruct
    sums (each shape's times its count)."""
    import torch

    from nsc_tpu_torch.ops import quant as Q

    seen, counts = {}, {}
    originals = (Q.int_conv1d, Q.int_conv_transpose1d)

    def record(kind, fn):
        def call(x8, w8, stride=1, dilation=1):
            key = (kind, tuple(x8.shape), tuple(w8.shape), stride, dilation)
            counts[key] = counts.get(key, 0) + 1
            if key not in seen:
                seen[key] = (x8.clone(), w8.clone())
            return fn(x8, w8, stride, dilation) if kind == "conv" else fn(x8, w8, stride)
        return call

    Q.int_conv1d = record("conv", originals[0])
    Q.int_conv_transpose1d = record("transpose", originals[1])
    try:
        bundle.model.reconstruct(bundle.params, bundle.rvq, wav)
        torch.cuda.synchronize()
    finally:
        Q.int_conv1d, Q.int_conv_transpose1d = originals
    rows, sums = [], {"ms": 0.0, "plain_ms": 0.0 if plain else None, "bound_ms": 0.0,
                      "bytes_ms": 0.0, "ops_ms": 0.0, "bit_exact": True if plain else None}
    for key, (x8, w8) in seen.items():
        kind, _, _, stride, dilation = key
        if kind == "conv":
            route = lambda: Q.int_conv1d_mm(x8, w8, stride, dilation)  # noqa: E731
            ref_fn = lambda: Q.int_conv1d_plain(x8, w8, stride, dilation)  # noqa: E731
        else:
            route = lambda: Q.int_conv_transpose1d_mm(x8, w8, stride)  # noqa: E731
            ref_fn = lambda: Q.int_conv_transpose1d_plain(x8, w8, stride)  # noqa: E731
        out = route()
        torch.cuda.synchronize()
        macs = out.numel() * (w8.numel() // out.shape[1]) if kind == "conv" else (
            x8.shape[0] * x8.shape[2] * w8.numel())
        b_ms = (x8.numel() + w8.numel() + 4 * out.numel()) / PEAK_BYTES * 1e3
        o_ms = 2 * macs / PEAK_INT8_OPS * 1e3
        rec = {"kind": kind, "x8": list(x8.shape), "w8": list(w8.shape), "stride": stride,
               "dilation": dilation, "count": counts[key], "ms": events_ms(route, reps=5),
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms > o_ms else "operations"}
        if plain:
            ref = ref_fn()
            torch.cuda.synchronize()
            rec["bit_exact"] = bool(torch.equal(out, ref))
            rec["plain_ms"] = events_ms(ref_fn, reps=2)
            sums["bit_exact"] &= rec["bit_exact"]
            sums["plain_ms"] += counts[key] * rec["plain_ms"]
            del ref
        for k2, v in (("ms", rec["ms"]), ("bound_ms", rec["bound_ms"]), ("bytes_ms", b_ms),
                      ("ops_ms", o_ms)):
            sums[k2] += counts[key] * v
        rows.append(rec)
        del out
    sums["sites"] = sum(counts.values())
    sums["shapes"] = len(seen)
    del seen
    return {"shapes": rows, "per_reconstruct": sums}


def int8_smoke(dev, serve, f32, wav_np, card, events_ms):
    """int8 serving on the flagship: `quantize_model` of the serving bundle
    (default calibration), its reconstruct of the 64 x 10 s batch with the
    counters around it (K2 + split x1, K3 x1, the int8 product once per
    conv site, no stage kernel); the int8 product against its plain version
    bit for bit at every distinct conv site shape at B 8 x 10 s, and timed
    at the 64 x 10 s batch's; index agreement and decode divergence against
    the float32 and the bf16 "auto" paths (reported); the float32 int8 path
    with nsc_tpu's scales (reference_int8.npz) on both probes under the
    margin rule; the port's own scales against nsc_tpu's (reported).
    Returns (the int8 serving bundle, its launches, its summary)."""
    import dataclasses

    import numpy as np
    import torch

    from nsc_tpu_torch import api, canonical, kernels
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec
    from nsc_tpu_torch.ops import quant as Q

    t0 = time.perf_counter()
    qserve = api.quantize_model(serve)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    n_sites = len(list(Q._conv_sites(qserve.params)))
    check(qserve.model.kernels.units == "reference" and qserve.model.kernels.rvq
          and qserve.cfg.compute_dtype == "bfloat16",
          f"int8 serving bundle: {qserve.model.kernels}, {qserve.cfg.compute_dtype}")
    wav = torch.from_numpy(wav_np).to(dev)
    kernels.reset_launches()
    out = qserve.model.reconstruct(qserve.params, qserve.rvq, wav)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1,
                   "int_mm": n_sites})
    emit({"phase": "int8", "what": "reconstruct", "sites": n_sites, "calibration_seconds": cal_s,
          "shape": list(out.shape), "finite": bool(torch.isfinite(out).all().item()),
          "launches": launches})
    check(tuple(out.shape) == tuple(wav.shape) and torch.isfinite(out).all().item(),
          "int8 reconstruct output")
    check(launches == expect, f"int8 launch counts {launches}, expected {expect}")
    del out

    # the int8 product: bit-exact at every conv site shape of B 8 x 10 s,
    # timed at the serving batch's
    small = int8_product_shapes(dev, qserve, wav[:INT8_CHECK_ROWS], events_ms, plain=True)
    for rec in small["shapes"]:
        emit({"phase": "kernel_check", "kernel": "int8_product", "batch": INT8_CHECK_ROWS, **rec})
    emit({"phase": "kernel_check", "kernel": "int8_product", "batch": INT8_CHECK_ROWS,
          "per_reconstruct": small["per_reconstruct"], "card": card})
    check(small["per_reconstruct"]["bit_exact"] and small["per_reconstruct"]["sites"] == n_sites,
          "int8 product: the route differs from its plain version at a site shape")
    full = int8_product_shapes(dev, qserve, wav, events_ms, plain=False)
    emit({"phase": "timing", "kernel": "int8_product", "batch": wav.shape[0],
          "shapes": full["shapes"], "per_reconstruct": full["per_reconstruct"], "card": card})

    # drift against the float32 and the bf16 "auto" paths (reported)
    idx_f = f32.model.encode(f32.params, f32.rvq, wav)
    idx_q = qserve.model.encode(qserve.params, qserve.rvq, wav)
    idx_s = serve.model.encode(serve.params, serve.rvq, wav)
    dec_f = f32.model.decode(f32.params, f32.rvq, idx_f)
    dec_q = qserve.model.decode(qserve.params, qserve.rvq, idx_f)
    dec_s = serve.model.decode(serve.params, serve.rvq, idx_f)
    emit({"phase": "int8", "what": "int8_vs_float32_and_auto",
          "vs_float32": drift(idx_q, idx_f, dec_q, dec_f),
          "vs_auto": drift(idx_q, idx_s, dec_q, dec_s),
          "auto_vs_float32": drift(idx_s, idx_f, dec_s, dec_f)})
    del idx_f, idx_q, idx_s, dec_f, dec_q, dec_s

    # the float32 int8 path with nsc_tpu's scales against nsc_tpu's CPU
    # int8 reference: frame by frame (reported), and by its fidelity to
    # nsc_tpu's float32 indices (gated, see INT8_AGREEMENT_TOL)
    with np.load(os.path.join(EXPORT, "reference_int8.npz"), allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(os.path.join(EXPORT, "reference_f32.npz"), allow_pickle=False) as z:
        ref_f32 = {k: z[k] for k in z.files}
    check(int(ref["fingerprint"]) == api.codebook_fingerprint(f32.rvq),
          "reference_int8.npz: other codebooks")
    jax_scales = [torch.from_numpy(ref[f"a_s_{i}"]) for i in range(n_sites)]
    q32 = api.ModelBundle(NeuralSpeechCodec(dataclasses.replace(f32.cfg, quant="int8")),
                          Q.with_scales(f32.params, jax_scales), f32.rvq)
    probes = {"noise": canonical.probe_input(f32.cfg), "speech": canonical.speech_probe_input(f32.cfg)}
    for name, x in probes.items():
        idx = api.encode(q32, x)
        r8, rf = ref[f"indices_{name}"], ref_f32[f"indices_{name}"]
        rec = first_flips(idx, r8, ref[f"margins_{name}"])
        fidelity = {"port_int8": float((idx == rf).mean()), "nsc_tpu_int8": float((r8 == rf).mean()),
                    "port_int8_book0": float((idx[..., 0] == rf[..., 0]).mean()),
                    "nsc_tpu_int8_book0": float((r8[..., 0] == rf[..., 0]).mean())}
        emit({"phase": "int8", "what": "float32_int8_vs_nsc_tpu_cpu_reference", "probe": name,
              "rows": x.shape[0], **rec, "entries_equal": float((idx == r8).mean()),
              "book0_equal": float((idx[..., 0] == r8[..., 0]).mean()),
              "agreement_with_nsc_tpu_float32": fidelity})
        for key in ("", "_book0"):
            gap = abs(fidelity[f"port_int8{key}"] - fidelity[f"nsc_tpu_int8{key}"])
            check(gap <= INT8_AGREEMENT_TOL, f"float32 int8 {name} probe: agreement with "
                  f"nsc_tpu's float32 indices{key} {fidelity}, more than {INT8_AGREEMENT_TOL} "
                  "from nsc_tpu's own int8 path's")

    # the port's own calibration against nsc_tpu's scales (reported)
    def scale_diff(b):
        got = [s["a_s"].float().cpu() for s in Q._conv_sites(b.params)]
        rel = [((g - j).abs() / j.abs().clamp_min(1e-30)).max().item()
               for g, j in zip(got, jax_scales)]
        return {"max_rel": max(rel), "median_rel": float(np.median(rel))}

    emit({"phase": "int8", "what": "calibration_vs_nsc_tpu",
          "float32": scale_diff(api.quantize_model(f32)), "serving_bf16": scale_diff(qserve)})
    del q32
    return qserve, launches, {"product": small["per_reconstruct"],
                              "product_serving": full["per_reconstruct"]}


def stacked_smoke(dev, f32, wav_np, card) -> dict:
    """The float32 flagship with conv_backend "stacked": latents within
    STACKED_LATENT_TOL x max|z| of "reference" on the 64 x 10 s batch,
    indices by the margin rule against the reference path's, and both
    paths' reconstruct RTF. Returns the RTFs."""
    import dataclasses

    import torch

    from nsc_tpu_torch import api
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec
    from nsc_tpu_torch.ops import rvq as rvq_ops

    stk = api.ModelBundle(NeuralSpeechCodec(dataclasses.replace(f32.cfg, conv_backend="stacked")),
                          f32.params, f32.rvq)
    wav = torch.from_numpy(wav_np).to(dev)
    z_ref = f32.model.latents(f32.params, wav)
    z_stk = stk.model.latents(stk.params, wav)
    err = (z_stk - z_ref).abs().max().item()
    top = z_ref.abs().max().item()
    margins = rvq_ops.argmin_margins(f32.rvq, z_ref).cpu().numpy()
    rec = first_flips(stk.model.encode(stk.params, stk.rvq, wav).cpu().numpy(),
                      f32.model.encode(f32.params, f32.rvq, wav).cpu().numpy(), margins)
    rtf = {"reference": reconstruct_rtf(f32, wav), "stacked": reconstruct_rtf(stk, wav)}
    emit({"phase": "stacked", "latent_max_abs_err": err, "latent_max_abs": top,
          "latent_err_over_max": err / top, **rec})
    emit({"phase": "timing", "what": "reconstruct", "path": "float32", "conv_backend": rtf,
          "card": card})
    check(err <= STACKED_LATENT_TOL * top,
          f"stacked latents {err} from reference's, above {STACKED_LATENT_TOL} x {top}")
    check(rec["ok"], f"stacked: an index differs from reference's where its margin is not "
          f"below {K2_NEAR_TIE}")
    del z_ref, z_stk, stk
    return rtf


def doctor_smoke(card) -> dict:
    """`python3 -m nsc_tpu_torch doctor --json` in a fresh process: rc 0,
    device_status "ok", the card's name."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nsc_tpu_torch", "doctor", "--json"], cwd=root,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.stdout.strip() else {}
    emit({"phase": "doctor", "rc": proc.returncode, "wall_seconds": wall, "report": out,
          "stderr_tail": proc.stderr[-400:]})
    check(proc.returncode == 0 and out.get("device_status") == "ok",
          f"doctor: rc {proc.returncode}, {out}")
    check(card.split(",")[0].strip() in out.get("devices", []), f"doctor: devices {out}")
    return out


def trace_smoke(serve, qserve, wav_np, card) -> dict:
    """`profiling.trace` around one "auto" reconstruct of the batch, one
    int8 reconstruct, and one streaming dispatch at queue 1 (after a warm
    call of each): each window's top kernels by self time and its idle
    share (`profiling.summarize`; reported, not gated)."""
    import tempfile

    import torch

    from nsc_tpu_torch import api, canonical
    from nsc_tpu_torch.utils import profiling

    wav = torch.from_numpy(wav_np).to(serve.device)
    one_s = canonical.speech_probe_input(serve.cfg, 1)[0, : int(STREAM_CHUNK_SECONDS * serve.cfg.sample_rate)]
    runs = {
        "auto_reconstruct": lambda: serve.model.reconstruct(serve.params, serve.rvq, wav),
        "int8_reconstruct": lambda: qserve.model.reconstruct(qserve.params, qserve.rvq, wav),
        "streaming_dispatch_queue1": lambda: api.streaming_compress(
            serve, one_s, STREAM_CHUNK_SECONDS, queue_chunks=1),
    }
    out = {}
    with tempfile.TemporaryDirectory(prefix="nsc_trace_") as tmp:
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiling.trace(os.path.join(tmp, name)) as prof:
                fn()
            wall = time.perf_counter() - t0
            summary = profiling.summarize(prof, top=10)
            out[name] = summary
            emit({"phase": "trace", "what": name, "traced_wall_ms": wall * 1e3, **summary,
                  "card": card})
    return out


def dp_smoke(dev, card, step_ms: float) -> dict:
    """Data parallelism on the card: a one-rank NCCL group (a FileStore in
    a temporary directory); `make_parallel_train_step` for DP_STEPS steps
    of the flagship config at full width (TrainConfig defaults) on the
    training phase's batches, beside the plain step from the same state,
    both under `deterministic()`: metrics, parameters, optimizer states and
    codebooks bit-equal, the counters around the data-parallel steps (K2 +
    split x1 and K4 x12 per step). The two steps timed in turns outside
    `deterministic()`. Reported between: two gloo ranks on the card against
    the plain step (`two_gloo_ranks`). Then the entry point twice in
    subprocesses, DP_STEPS
    steps each with --deterministic: `python -m torch.distributed.run
    --nproc_per_node 1 -m nsc_tpu_torch.train --distributed` and the same
    without the launcher and --distributed; their metrics rows (the last
    step's at the default log cadence; all keys but steps_per_sec) must be
    equal. Returns the data-parallel steps' counts."""
    import copy
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from nsc_tpu_torch import kernels, parallel
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.train import data as data_lib
    from nsc_tpu_torch.train import loop as L
    from nsc_tpu_torch.train import train as T

    cfg, tcfg = get_config(FLAGSHIP), TrainConfig(**DP_OVERRIDES)
    seg = L.segment_length(cfg, tcfg.segment_seconds)
    source = data_lib.make_source("synthetic", cfg.sample_rate, tcfg.seed)
    batches = [torch.from_numpy(next(source.batches(tcfg.batch_size, seg))).to(dev)
               for _ in range(DP_STEPS)]
    tmp = tempfile.mkdtemp(prefix="nsc_dp_")
    first = {}  # the plain step's parameters and codebooks after its first step
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                                rank=0, world_size=1, **kw)
        mesh = parallel.make_mesh(dev)
        with deterministic():
            model, plain_state = T.init_train_state(cfg, tcfg, dev)
            L.data_init_codebooks(model, plain_state, tcfg, "synthetic")
            dp_state = parallel.replicate(mesh, copy.deepcopy(plain_state))
            plain = T.make_train_step(model, tcfg)
            step = parallel.make_parallel_train_step(model, tcfg, mesh)
            want = []
            for b in batches:
                plain_state, m = plain(plain_state, b)
                want.append({k: float(v) for k, v in m.items()})
                if not first:
                    first.update(params_g=[x.detach().cpu() for x in
                                           T.tree_leaves(plain_state["params_g"])],
                                 codebooks=plain_state["rvq"]["codebooks"].cpu())
            kernels.reset_launches()
            got = []
            for b in batches:
                dp_state, m = step(dp_state, parallel.shard_batch(mesh, b))
                got.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        same = {part: trees_equal(plain_state[part], dp_state[part])
                for part in ("params_g", "params_d", "rvq", "opt_g", "opt_d")}
        emit({"phase": "main", "what": "dp", "world": mesh.size, "backend": dist.get_backend(),
              "steps": DP_STEPS, "metrics_equal": got == want, "state_equal": same,
              "launches": launches, "metrics": got})
        check(got == want, f"dp: one-rank metrics differ from the plain step's: {got} vs {want}")
        check(all(same.values()), f"dp: state differs from the plain step's: {same}")
        expect = dict.fromkeys(kernels.LAUNCHES, 0)
        expect.update({"rvq_quantize": DP_STEPS, "rvq_split_planes": DP_STEPS,
                       "stft_magnitude": 12 * DP_STEPS})
        check(launches == expect, f"dp launch counts {launches}, expected {expect}")

        # one step each in turns (plain, dp, dp, plain), PyTorch's defaults
        def one(fn, state, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, b)
            torch.cuda.synchronize()
            return out[0], (time.perf_counter() - t0) * 1e3

        turns = []
        for kind in ("plain", "dp", "dp", "plain"):
            if kind == "plain":
                plain_state, ms = one(plain, plain_state, batches[0])
            else:
                dp_state, ms = one(step, dp_state, parallel.shard_batch(mesh, batches[0]))
            turns.append((kind, ms))
        plain_ms = (turns[0][1] + turns[3][1]) / 2
        dp_ms = (turns[1][1] + turns[2][1]) / 2
        emit({"phase": "timing", "what": "dp_step", "world": 1, "turns_ms": turns,
              "plain_ms": plain_ms, "dp_ms": dp_ms, "dp_over_plain": dp_ms / plain_ms,
              "training_phase_step_ms": step_ms, "card": card})
        global_batch = batches[0].cpu()
        del plain_state, dp_state, batches
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        two_gloo_ranks(tmp, global_batch, want[0], first, tcfg)

        # the entry point through the launcher, and without it
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        args = ["--config", FLAGSHIP, "--data", "synthetic", "--steps", str(DP_STEPS),
                "--deterministic", "--no-resume", *LOOP_ARGS]
        runs = {}
        for name, cmd in (
                ("torch.distributed.run", [sys.executable, "-m", "torch.distributed.run",
                                           "--standalone", "--nproc_per_node", "1", "-m",
                                           "nsc_tpu_torch.train", "--distributed"]),
                ("plain", [sys.executable, "-m", "nsc_tpu_torch.train"])):
            wd = os.path.join(tmp, name)
            t0 = time.perf_counter()
            proc = subprocess.run(cmd + args + ["--workdir", wd], cwd=root, env=env,
                                  capture_output=True, text=True, timeout=900)
            rows = []
            if os.path.exists(os.path.join(wd, "metrics.jsonl")):
                with open(os.path.join(wd, "metrics.jsonl")) as f:
                    rows = [json.loads(line) for line in f]
            runs[name] = rows
            emit({"phase": "main", "what": "dp_entry_point", "run": name, "rc": proc.returncode,
                  "seconds": time.perf_counter() - t0, "rows": len(rows),
                  "stderr_tail": proc.stderr[-600:] if proc.returncode else ""})
            check(proc.returncode == 0, f"dp entry point ({name}): rc {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
        strip = lambda rows: [{k: v for k, v in r.items() if k != "steps_per_sec"}  # noqa: E731
                              for r in rows]
        a, b = strip(runs["torch.distributed.run"]), strip(runs["plain"])
        emit({"phase": "main", "what": "dp_entry_point_rows_equal", "equal": a == b,
              "steps": [r["step"] for r in a]})
        check(a and a[-1]["step"] == DP_STEPS and a == b,
              f"dp entry point: --distributed rows {a} differ from the plain run's {b}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _dp2_rank(rank: int, tmp: str, overrides: dict) -> None:
    """One of the two gloo ranks of `two_gloo_ranks` (a spawned process on
    card 0): the flagship config's state from seed, rank 0's data init
    broadcast, one data-parallel step on its half of the saved batch; its
    metrics, parameters and codebooks go to `tmp`."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nsc_tpu_torch import parallel
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.train import loop as L
    from nsc_tpu_torch.train import train as T

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store2"), 2),
                            rank=rank, world_size=2)
    try:
        mesh = parallel.make_mesh(dev)
        cfg, tcfg = get_config(FLAGSHIP), TrainConfig(**overrides)
        model, state = T.init_train_state(cfg, tcfg, dev)
        if rank == 0:
            L.data_init_codebooks(model, state, tcfg, "synthetic")
        parallel.replicate(mesh, state)
        batch = torch.load(os.path.join(tmp, "global_batch.pt"))
        step = parallel.make_parallel_train_step(model, tcfg, mesh)
        state, metrics = step(state, parallel.shard_batch(mesh, batch))
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                    "params_g": [x.detach().cpu() for x in T.tree_leaves(state["params_g"])],
                    "codebooks": state["rvq"]["codebooks"].cpu(),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
                   os.path.join(tmp, f"dp2_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_gloo_ranks(tmp: str, global_batch, want: dict, first: dict, tcfg) -> None:
    """Reported, not gated: two gloo ranks sharing the one card (NCCL takes
    one rank per device) run one data-parallel step on the halves of the
    global batch, held to the plain one-process step on the whole batch with
    the JAX package's DP tolerances (metrics rtol 2e-3 / atol 2e-4,
    parameters rtol 0.2 / atol 4 x lr, codebooks rtol 1e-4 / atol 1e-5);
    and the two ranks' codebooks bit for bit."""
    import multiprocessing as mp

    import torch

    torch.save(global_batch, os.path.join(tmp, "global_batch.pt"))
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dp2_rank, args=(r, tmp, DP_OVERRIDES)) for r in range(2)]
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join(timeout=240)
    for pr in procs:
        if pr.is_alive():
            pr.kill()
            pr.join()
    codes = [pr.exitcode for pr in procs]
    paths = [os.path.join(tmp, f"dp2_rank{r}.pt") for r in range(2)]
    if codes != [0, 0] or not all(map(os.path.exists, paths)):
        emit({"phase": "main", "what": "dp_two_gloo_ranks", "ran": False, "exit_codes": codes,
              "seconds": time.perf_counter() - t0})
        return
    a, b = (torch.load(p) for p in paths)
    close = lambda x, y, rtol, atol: bool(torch.allclose(x, y, rtol=rtol, atol=atol))  # noqa: E731
    metric_err = {k: abs(a["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
    emit({"phase": "main", "what": "dp_two_gloo_ranks", "ran": True,
          "seconds": time.perf_counter() - t0, "peak_gb_per_rank": [a["peak_gb"], b["peak_gb"]],
          "ranks_metrics_equal": a["metrics"] == b["metrics"],
          "ranks_codebooks_equal": bool(torch.equal(a["codebooks"], b["codebooks"])),
          "metrics_within_tol": all(abs(a["metrics"][k] - v) <= 2e-4 + 2e-3 * abs(v)
                                    for k, v in want.items()),
          "metric_rel_err": metric_err,
          "params_within_tol": all(close(x, y, 0.2, 4 * tcfg.lr_g)
                                   for x, y in zip(a["params_g"], first["params_g"])),
          "codebooks_within_tol": close(a["codebooks"], first["codebooks"], 1e-4, 1e-5),
          "codebooks_max_abs_diff": float((a["codebooks"] - first["codebooks"]).abs().max())})


def sweep_smoke(dev, serve, card, events_ms, export=EXPORT, name=FLAGSHIP,
                what="flagship", require_all=False) -> dict:
    """The bitrate sweep (`eval.sweep.bitrate_sweep`) on the first clips of
    the speech probe: the float32 bundle of `export` (a `name` model; the
    flagship's by default) held to nsc_tpu's CPU
    float32 rows (reference_sweep.json): n_q and bitrate_bps equal at every
    depth; at every depth where the port's indices equal the reference's
    (reference_f32.npz), the index-derived fields equal and the float fields
    within SWEEP_TOL (require_all: every depth must be held); then the
    serving bundle with the counters around the sweep (K2 + split x1 for the one encode; K3 x1 and K1 x4, the decoder's
    stages, per depth; K1 x4 for the encoder), its indices at every depth d
    against the first d books of the full encode, and its device time (one
    encode and a decode per depth) beside one reconstruct of the same clips.
    Returns the serving sweep's counts."""
    import numpy as np
    import torch

    from nsc_tpu_torch import api, canonical, kernels
    from nsc_tpu_torch.eval.sweep import bitrate_sweep

    with open(os.path.join(export, "reference_sweep.json")) as f:
        ref = json.load(f)
    f32 = api.load_model(name, checkpoint=export, device=dev)
    check(ref["fingerprint"] == api.codebook_fingerprint(f32.rvq),
          "reference_sweep.json is of other codebooks")
    clips = ref["clips"]
    wavs = canonical.speech_probe_input(f32.cfg)[:clips]
    t0 = time.perf_counter()
    rows = bitrate_sweep(f32, wavs)
    f32_s = time.perf_counter() - t0
    idx = api.encode(f32, wavs)
    with np.load(os.path.join(export, "reference_f32.npz")) as z:
        ref_idx = z["indices_speech"][:clips]
    check(len(rows) == len(ref["rows"]) == f32.cfg.num_quantizers, "sweep: depth count")
    held, worst = [], {}
    for g, w in zip(rows, ref["rows"]):
        d = g["n_q"]
        check(d == w["n_q"] and g["bitrate_bps"] == w["bitrate_bps"] and list(g) == list(w),
              f"sweep depth {d}: n_q/bitrate/keys {g} vs {w}")
        if not np.array_equal(idx[..., :d], ref_idx[..., :d]):
            continue
        held.append(d)
        for k in SWEEP_INDEX_FIELDS:
            check(g[k] == w[k], f"sweep depth {d}: {k} {g[k]} vs the reference's {w[k]}")
        for k, (rtol, atol) in SWEEP_TOL.items():
            check((k in g) == (k in w), f"sweep depth {d}: {k} present on one side only")
            if k in w:
                err = abs(g[k] - w[k])
                worst[k] = max(worst.get(k, 0.0), err)
                check(err <= atol + rtol * abs(w[k]),
                      f"sweep depth {d}: {k} {g[k]} vs the reference's {w[k]}")
    emit({"phase": "main", "what": "sweep", "bundle": f"{what} float32", "clips": clips,
          "depths_held": held, "worst_abs_diff": worst, "seconds": f32_s,
          "rows": [{k: r[k] for k in ("n_q", "bitrate_bps", "entropy_bitrate_bps",
                                      "mel_distance", "si_snr_db")} for r in rows]})
    check(held, "sweep: the float32 indices differ from the reference's at every depth")
    if require_all:
        check(held == list(range(1, len(rows) + 1)),
              f"{what} sweep: the float32 indices equal the reference's only at depths {held}")
    del f32

    # the serving bundle, counted
    n_q = serve.cfg.num_quantizers
    kernels.reset_launches()
    t0 = time.perf_counter()
    srows = bitrate_sweep(serve, wavs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stages = len(serve.cfg.strides)
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"residual_stack": stages * (1 + n_q), "rvq_quantize": 1,
                   "rvq_split_planes": 1, "rvq_dequantize": n_q})
    full = api.encode(serve, wavs)
    prefix = [d for d in range(1, n_q + 1)
              if np.array_equal(api.encode(serve, wavs, n_q=d), full[..., :d])]
    x = torch.from_numpy(wavs).to(dev)
    p, q = serve.params, serve.rvq
    enc_ms = events_ms(lambda: serve.model.encode(p, q, x), reps=3)
    idx_t = serve.model.encode(p, q, x)
    dec_ms = [events_ms(lambda d=d: serve.model.decode(p, q, idx_t[..., :d]), reps=3)
              for d in range(1, n_q + 1)]
    rec_ms = events_ms(lambda: serve.model.reconstruct(p, q, x), reps=3)
    emit({"phase": "main", "what": "sweep", "bundle": f"{what} serving", "launches": launches,
          "prefix_depths_equal": len(prefix), "seconds": serve_s,
          "rows": [{k: r[k] for k in ("n_q", "entropy_bitrate_bps", "mel_distance")}
                   for r in srows]})
    emit({"phase": "timing", "what": "sweep", "bundle": f"{what} serving", "clips": clips,
          "seconds_f32_sweep": f32_s, "seconds_serving_sweep": serve_s,
          "encode_ms": enc_ms, "decode_ms_by_depth": dec_ms,
          "device_ms": enc_ms + sum(dec_ms), "reconstruct_ms": rec_ms,
          "device_over_reconstruct": (enc_ms + sum(dec_ms)) / rec_ms, "card": card})
    check(launches == expect, f"serving sweep launch counts {launches}, expected {expect}")
    check(len(prefix) == n_q, f"serving sweep: depth-d encodes differ from the full encode's "
          f"first d books (equal at {prefix})")
    return launches


def native_smoke(serve, wav_np, card) -> None:
    """The C coder (`nsc_tpu_torch.native`) must be the active path; on the
    flagship's serving indices of the 64 x 10 s batch its packed planes and
    its arithmetic-coded planes must be byte-identical to the numpy
    coder's, and decode back to the indices; both timed on the host."""
    import numpy as np

    from nsc_tpu_torch import api, bitstream, entropy, native

    check(native.available(), f"native coder unavailable: {native.unavailable_reason()}")
    idx = api.encode(serve, wav_np)
    bits = serve.cfg.bits_per_codebook
    k = 2**bits
    frames, n_q = idx.shape[1:]
    planes = [(r, q) for r in range(idx.shape[0]) for q in range(n_q)]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    pk_c, pack_c = timed(lambda: [native.pack_frames(row, bits) for row in idx])
    pk_n, pack_n = timed(lambda: [bitstream.pack_frames_numpy(row, bits) for row in idx])
    up_c, unpack_c = timed(lambda: [native.unpack_frames(b, frames, n_q, bits) for b in pk_c])
    up_n, unpack_n = timed(lambda: [bitstream.unpack_frames_numpy(b, frames, n_q, bits)
                                    for b in pk_c])
    ac_c, enc_c = timed(lambda: [native.ac_encode_plane(idx[r, :, q], k, entropy.REBUILD,
                                                        entropy.RESCALE_AT) for r, q in planes])
    ac_n, enc_n = timed(lambda: [entropy.encode_plane_numpy(idx[r, :, q], k) for r, q in planes])
    dc_c, dec_c = timed(lambda: [native.ac_decode_plane(c, frames, k, entropy.REBUILD,
                                                        entropy.RESCALE_AT) for c in ac_c])
    dc_n, dec_n = timed(lambda: [entropy.decode_plane_numpy(c, frames, k) for c in ac_c])
    packed_same = pk_c == pk_n
    coded_same = ac_c == ac_n
    unpacked = all(np.array_equal(a, row) and np.array_equal(b, row)
                   for a, b, row in zip(up_c, up_n, idx))
    decoded = all(np.array_equal(a, idx[r, :, q]) and np.array_equal(b, idx[r, :, q])
                  for a, b, (r, q) in zip(dc_c, dc_n, planes))
    symbols = idx.size
    emit({"phase": "main", "what": "native", "available": True, "symbols": symbols,
          "packed_identical": packed_same, "coded_identical": coded_same,
          "unpacked": unpacked, "decoded": decoded,
          "packed_bytes": sum(map(len, pk_c)), "coded_bytes": sum(map(len, ac_c))})
    emit({"phase": "timing", "what": "native_coder", "host": True, "symbols": symbols,
          "pack_ms": {"c": pack_c, "numpy": pack_n, "speedup": pack_n / pack_c},
          "unpack_ms": {"c": unpack_c, "numpy": unpack_n, "speedup": unpack_n / unpack_c},
          "ac_encode_ms": {"c": enc_c, "numpy": enc_n, "speedup": enc_n / enc_c},
          "ac_decode_ms": {"c": dec_c, "numpy": dec_n, "speedup": dec_n / dec_c},
          "card": card})
    check(packed_same and unpacked, "native: packed planes differ from numpy's")
    check(coded_same and decoded, "native: arithmetic-coded planes differ from numpy's")


def serving_expect(name: str) -> dict:
    """The launches of one `reconstruct` of `name`'s serving bundle: the
    stage kernel its serving config routes the residual units to, once per
    stage of the encoder and of the decoder (none where the units run op by
    op, as in a non-causal config), K2 and its codebook split once, K3
    once, nothing else."""
    from nsc_tpu_torch import api, kernels
    from nsc_tpu_torch.configs import get_config
    from nsc_tpu_torch.models import seanet

    cfg = api.serving_config(get_config(name))
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    route = seanet.unit_route(cfg)
    if route != "reference":
        expect[route] = 2 * len(cfg.strides)
    expect.update({"rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1})
    return expect


def stage_error(got, ref, dname: str, what: str, time_axis: int = -1, **fields) -> dict:
    """A stage kernel's output against its plain version's under K1_TOL
    (max and mean abs error, relative to max(1, max|ref|)), printed as a
    kernel_check line with `fields` and the error of the first 64 steps of
    `time_axis`, then gated. Returns the errors."""
    import torch

    err = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    rec = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "max_abs_ref": scale, "max_rel_err": err.max().item() / max(scale, 1e-30),
           "first_tile_max_abs_err": err.narrow(time_axis, 0, min(64, err.shape[time_axis])).max().item(),
           "frac_differ": (got != ref).float().mean().item()}
    emit({"phase": "kernel_check", **fields, "dtype": dname, **rec})
    tol_max, tol_mean = K1_TOL[dname]
    check(tuple(got.shape) == tuple(ref.shape), f"{what}: shape {tuple(got.shape)}")
    check(torch.isfinite(got).all().item(), f"{what}: non-finite output")
    check(rec["max_abs_err"] <= tol_max * max(1.0, scale), f"{what}: max abs err {rec['max_abs_err']}")
    check(rec["mean_abs_err"] <= tol_mean * max(1.0, scale),
          f"{what}: mean abs err {rec['mean_abs_err']}")
    return rec


def config_kernels(serve, wav, events_ms) -> dict:
    """K1 on every stage the serving bundle launches it on (bf16, the
    bundle's packed weights, N(0, 0.25) input of the stage's shape at the
    batch's B and T), K2 on the bundle's own latents of `wav` (near-tie rule;
    its winning scores within K2_SCORE_ULPS of float64) and K3 on the plain
    indices (bit-exact), each against its plain version; then each timed
    by CUDA events beside its bound (as the main path's). Returns
    {kernel: {max_abs_err, ms, bound_ms, bound_by, ...}}."""
    import torch

    from nsc_tpu_torch.kernels import residual_stack as RS
    from nsc_tpu_torch.kernels import rvq as KR
    from nsc_tpu_torch.ops.precision import float32_numerics

    cfg, params, rvq = serve.cfg, serve.params, serve.rvq
    dev = wav.device
    b = wav.shape[0]
    out = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    if serve.model.kernels.units == "residual_stack":
        fast, dil = cfg.activation == "snake_fast", tuple(cfg.dilations)
        k1 = {"max_abs_err": 0.0, "ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
              "stages": []}
        for st in stage_list(cfg, wav.shape[1]):
            c, t = st["units_ct"]
            p = params[st["part"]]["stages"][st["i"]]["stack"]
            x = (torch.randn(b, c, t, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
            got = RS.residual_stack(x, p, dil, fast)
            torch.cuda.synchronize()
            rec = stage_error(got, RS.residual_stack_plain(x, p, dil, fast), "bfloat16",
                              f"{cfg.name} residual_stack {st['name']}", kernel="residual_stack",
                              config=cfg.name, stage=st["name"], B=b, in_shape=list(x.shape))
            del got
            ms = events_ms(lambda: RS.residual_stack(x, p, dil, fast))
            b_ms, o_ms, _ = k1_bound(x, p, dil)
            k1["stages"].append({"stage": st["name"], "C": c, "T": t, "ms": ms})
            k1["max_abs_err"] = max(k1["max_abs_err"], rec["max_abs_err"])
            for key, v in (("ms", ms), ("bytes_ms", b_ms), ("ops_ms", o_ms),
                           ("bound_ms", max(b_ms, o_ms))):
                k1[key] += v
            del x
        k1["bound_by"] = "bytes" if k1["bytes_ms"] > k1["ops_ms"] else "operations"
        out["residual_stack"] = k1

    books = rvq["codebooks"].contiguous()
    n_q, k, d = books.shape
    z = serve.model.latents(params, wav).reshape(-1, d).float().contiguous()
    m = z.shape[0]
    idx_k, best_k = KR.quantize_with_scores(books, z)
    torch.cuda.synchronize()
    rec, idx_p = hold_quantize(books, z, idx_k, cfg.name)
    rec["score_abs_err_vs_float64"] = scores = k2_score_err(books, z, idx_k, best_k)
    check(scores["max_ulps"] <= K2_SCORE_ULPS,
          f"{cfg.name} K2's winning scores lie {scores['max_ulps']} float32 ulps from float64")
    q_bytes_ms, q_ops_ms = k2_bound(books, m)
    out["rvq_quantize"] = {"M": m, "n_q": n_q, "K": k, "D": d, "plan": KR.quantize_plan(m, d),
                           **rec, "max_abs_err": rec["worst_first_mismatch_margin"],
                           "ms": events_ms(lambda: KR.quantize(books, z), reps=20),
                           "bound_ms": max(q_bytes_ms, q_ops_ms),
                           "bound_by": "bytes" if q_bytes_ms > q_ops_ms else "operations"}
    del idx_k, best_k, z
    got = KR.dequantize(books, idx_p)
    torch.cuda.synchronize()
    with float32_numerics():
        ref = KR.dequantize_plain(books, idx_p)
    exact = bool(torch.equal(got, ref))
    check(exact, f"{cfg.name} K3: not bit-exact against its plain version")
    dq_bytes_ms, dq_ops_ms = k3_bound(books, idx_p)
    out["rvq_dequantize"] = {"M": m, "bit_exact": exact,
                             "max_abs_err": (got - ref).abs().max().item(),
                             "ms": events_ms(lambda: KR.dequantize(books, idx_p), reps=50),
                             "bound_ms": max(dq_bytes_ms, dq_ops_ms),
                             "bound_by": "bytes" if dq_bytes_ms > dq_ops_ms else "operations"}
    return out


def config_float32(name: str, f32, serve, wav_np) -> dict:
    """`name`'s float32 path on the card against the port's CPU float32
    path (same seed-0 weights) on `wav_np`: the card's indices by the
    margin rule against the CPU's (gated), the decodes of the CPU's
    indices on both (reported), and the serving path's index agreement
    with the card's float32 (reported)."""
    import numpy as np
    import torch

    from nsc_tpu_torch import api
    from nsc_tpu_torch.ops import rvq as rvq_ops

    cpu = api.load_model(name, device="cpu")
    xc = torch.from_numpy(wav_np)
    xg = xc.to(f32.device)
    lat = cpu.model.latents(cpu.params, xc)
    idx_c = rvq_ops.quantize(cpu.rvq, lat, kernel=False)
    margins = rvq_ops.argmin_margins(cpu.rvq, lat).numpy()
    idx_g = f32.model.encode(f32.params, f32.rvq, xg)
    rec = first_flips(idx_g.cpu().numpy(), idx_c.numpy(), margins)
    check(rec["ok"], f"{name} float32: a card index differs from the CPU's where its margin is "
          f"not below {K2_NEAR_TIE}")
    dec_c = cpu.model.decode(cpu.params, cpu.rvq, idx_c)
    dec_g = f32.model.decode(f32.params, f32.rvq, idx_c.to(f32.device)).cpu()
    idx_s = serve.model.encode(serve.params, serve.rvq, xg)
    rms = dec_c.pow(2).mean().sqrt().item()
    return {**rec, "decode_max_abs": (dec_g - dec_c).abs().max().item(),
            "decode_rel_rms": (dec_g - dec_c).pow(2).mean().sqrt().item() / max(rms, 1e-12),
            "serving_index_agreement_with_float32": (idx_s == idx_g).float().mean().item(),
            "rows": int(wav_np.shape[0]), "seconds": wav_np.shape[1] / f32.cfg.sample_rate,
            "equal": bool(np.array_equal(idx_g.cpu().numpy(), idx_c.numpy()))}


def config_streaming(serve, wav_np) -> dict:
    """Streaming on `serve`: STREAM_ROWS rows of `wav_np` end to end in
    STREAM_CHUNK_SECONDS chunks at queue CONFIG_QUEUE. A causal config:
    streaming_compress / streaming_decompress round trip (the stream's
    indices decode to finite audio of the input's length) with the counters
    around both (K2 + split and K3 once per dispatch, nothing else), and
    the stream's agreement with batch compress (reported). A non-causal
    one: streaming_compress raises ValueError, as nsc_tpu's does. Returns
    the record; its "launches" are the counts."""
    import numpy as np
    import torch

    from nsc_tpu_torch import api, bitstream, kernels

    cfg = serve.cfg
    wav = np.ascontiguousarray(wav_np[:STREAM_ROWS].reshape(-1))
    seconds = wav.shape[0] / cfg.sample_rate
    if not cfg.causal:
        try:
            api.streaming_compress(serve, wav, STREAM_CHUNK_SECONDS, queue_chunks=CONFIG_QUEUE)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None, f"{cfg.name}: streaming_compress did not refuse a non-causal "
              "config")
        return {"refused": refused, "launches": dict.fromkeys(kernels.LAUNCHES, 0)}
    t0 = time.perf_counter()
    kernels.reset_launches()
    sblob = api.streaming_compress(serve, wav, STREAM_CHUNK_SECONDS, queue_chunks=CONFIG_QUEUE)
    back = api.streaming_decompress(serve, sblob, STREAM_CHUNK_SECONDS, queue_chunks=CONFIG_QUEUE)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    wall = time.perf_counter() - t0
    dispatches = -(-math.ceil(seconds / STREAM_CHUNK_SECONDS) // CONFIG_QUEUE)
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"rvq_quantize": dispatches, "rvq_split_planes": dispatches,
                   "rvq_dequantize": dispatches})
    idx_s = bitstream.deserialize(sblob)[1]
    idx_b = api.encode(serve, wav)
    finite = bool(np.isfinite(back).all())
    check(back.shape == wav.shape and finite, f"{cfg.name} streaming_decompress: shape or finiteness")
    check(idx_s.shape == idx_b.shape, f"{cfg.name} streaming indices: shape {idx_s.shape}")
    check(launches == expect, f"{cfg.name} streaming launch counts {launches}, expected {expect}")
    return {"seconds": seconds, "chunk_seconds": STREAM_CHUNK_SECONDS, "queue_chunks": CONFIG_QUEUE,
            "dispatches_each_way": dispatches, "launches": launches, "finite": finite,
            "index_agreement_with_batch": float((idx_s == idx_b).mean()),
            "round_trip_wall_seconds": wall}


def config_training(dev, name: str, card) -> dict:
    """CONFIG_TRAIN_STEPS steps of `name` at full width (TrainConfig
    defaults: 64 x 1 s, GAN on, step-0 data init of the codebooks), each
    with the counters around it: finite metrics, K2 + split x1 and K4 x12 a step (and K2 + split x3 per book in
    the data init); each step's time by CUDA events and the peak memory.
    Returns the steps' launch counts."""
    import torch

    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.train import data as data_lib
    from nsc_tpu_torch.train import loop as L
    from nsc_tpu_torch.train import train as T

    cfg, tcfg = get_config(name), TrainConfig()
    seg = L.segment_length(cfg, tcfg.segment_seconds)
    source = data_lib.make_source("synthetic", cfg.sample_rate, tcfg.seed)
    torch.cuda.reset_peak_memory_stats()
    model, state = T.init_train_state(cfg, tcfg, dev)
    step_fn = T.make_train_step(model, tcfg)
    kernels.reset_launches()
    L.data_init_codebooks(model, state, tcfg, "synthetic")
    init = dict(kernels.LAUNCHES)
    init_k2 = cfg.num_quantizers * 3  # per book: 2 Lloyd iterations + the final search
    check(init["rvq_quantize"] == init["rvq_split_planes"] == init_k2,
          f"{name} data-init launches {init}")
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"rvq_quantize": 1, "rvq_split_planes": 1, "stft_magnitude": 12})
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    step_ms, values = [], {}
    for i in range(CONFIG_TRAIN_STEPS):
        batch = torch.from_numpy(next(source.batches(tcfg.batch_size, seg))).to(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kernels.reset_launches()
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        step_ms.append(start.elapsed_time(end))
        values = {k: float(v) for k, v in metrics.items()}
        check(all(map(math.isfinite, values.values())), f"{name} step {i + 1}: non-finite metric")
        check(launches == expect, f"{name} step {i + 1}: launches {launches}, expected {expect}")
        for k, n in launches.items():
            total[k] += n
    peak = torch.cuda.max_memory_allocated()
    del state, model, metrics
    torch.cuda.empty_cache()
    return {"batch": tcfg.batch_size, "segment_samples": seg, "use_gan": tcfg.use_gan,
            "codebook_init": tcfg.codebook_init, "data_init_launches": init, "launches": total,
            "step_event_ms": step_ms, "peak_memory_gb": peak / 1e9,
            "last_step": {k: values[k] for k in ("loss/g_total", "loss/mel", "loss/stft")
                          if k in values}, "card": card}


def cli_roundtrip(bundle, model_args, exact: bool) -> dict:
    """`python3 -m nsc_tpu_torch compress` and `decompress` in fresh
    processes with `model_args` on 10 s of the speech probe, against the
    same calls on `bundle` in this process. exact: the stream's indices and
    the decoded WAV equal (the serving path); else the indices by the
    margin rule (the margins of this process's latents) and the WAV within
    CLI_PCM_TOL (a float32 path on cuDNN)."""
    import tempfile

    import numpy as np
    import torch

    from nsc_tpu_torch import api, bitstream, canonical
    from nsc_tpu_torch.ops import rvq as rvq_ops
    from nsc_tpu_torch.utils import audio

    cfg = bundle.cfg
    with tempfile.TemporaryDirectory(prefix="nsc_cli_") as tmp:
        wav_path, nsc_path = os.path.join(tmp, "speech.wav"), os.path.join(tmp, "speech.nsc")
        out_path, want_path = os.path.join(tmp, "out.wav"), os.path.join(tmp, "want.wav")
        audio.save_wav(wav_path, canonical.speech_probe_input(cfg, 1)[0], cfg.sample_rate)
        wav, _ = audio.load_wav(wav_path, target_sr=cfg.sample_rate)
        t0 = time.perf_counter()
        run_cli("compress", wav_path, nsc_path, *model_args, phase="configs_cli")
        run_cli("decompress", nsc_path, out_path, *model_args, phase="configs_cli")
        wall = time.perf_counter() - t0
        with open(nsc_path, "rb") as f:
            blob = f.read()
        got_idx, want_idx = bitstream.deserialize(blob)[1], api.encode(bundle, wav)
        lat = bundle.model.latents(bundle.params, torch.from_numpy(wav[None]).to(bundle.device))
        margins = rvq_ops.argmin_margins(bundle.rvq, lat)[0].cpu().numpy()
        rec = first_flips(got_idx, want_idx, margins[: want_idx.shape[0]])
        audio.save_wav(want_path, api.decompress(bundle, blob), cfg.sample_rate)
        got, want = audio.load_wav(out_path)[0], audio.load_wav(want_path)[0]
    same_shape = got.shape == want.shape == wav.shape
    wav_err = float(np.abs(got - want).max()) if same_shape else math.inf
    root = os.path.dirname(os.path.abspath(__file__))
    rec.update(model_args=[os.path.relpath(a, root) if os.path.isabs(a) else a for a in model_args],
               indices_equal=bool(np.array_equal(got_idx, want_idx)),
               wav_equal=same_shape and bool(np.array_equal(got, want)), wav_max_abs=wav_err,
               wall_seconds=wall)
    if exact:
        check(rec["indices_equal"] and rec["wav_equal"],
              f"CLI {model_args}: the stream or the WAV differs from the in-process calls")
    else:
        check(rec["ok"], f"CLI {model_args}: an index differs from the in-process encode where "
              f"its margin is not below {K2_NEAR_TIE}")
        check(wav_err <= CLI_PCM_TOL, f"CLI {model_args}: the WAV differs by {wav_err}")
    return rec


def configs_smoke(dev, wav_np, card, events_ms) -> dict:
    """The `configs` phase: every name of CONFIGS at full width with seed-0
    weights on the main input `wav_np` (64 x 10 s). Serving
    (`api.load_model(name, serving=True)`): reconstruct with the counters
    reset just before and read just after (`serving_expect`); for base, the
    serving activation snake_fast and its indices equal to base_fast's
    serving bundle's on the same weights, and no timing (the main path
    times that computation at those shapes); for every other, its RTF (mean
    of 3) and the kernels at its shapes (`config_kernels`). The float32
    path on the card against the CPU (`config_float32`), streaming
    (`config_streaming`) and training (`config_training`). Then one CLI
    round trip with the CLI's default model, base (float32). Returns the
    launch counts by path and each configuration's record."""
    import dataclasses

    import torch

    from nsc_tpu_torch import api, kernels, weights
    from nsc_tpu_torch.configs import get_config

    by_path, rows = {}, {}
    wav = torch.from_numpy(wav_np).to(dev)
    for name in CONFIGS:
        t0 = time.perf_counter()
        serve = api.load_model(name, serving=True, device=dev)
        cfg = serve.cfg
        expect = serving_expect(name)
        kernels.reset_launches()
        out = serve.model.reconstruct(serve.params, serve.rvq, wav)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        finite = bool(torch.isfinite(out).all().item())
        emit({"phase": "configs", "config": name, "what": "reconstruct", "shape": list(out.shape),
              "route": serve.model.kernels.units, "finite": finite, "launches": launches})
        check(tuple(out.shape) == tuple(wav.shape) and finite, f"{name}: reconstruct output")
        check(launches == expect, f"{name}: serving launch counts {launches}, expected {expect}")
        by_path[f"{name}_serving"] = launches
        del out
        rec = {}
        if name == "base":
            fast_cfg = api.serving_config(get_config("base_fast"))
            check(cfg.activation == "snake_fast" and dataclasses.replace(
                cfg, name="base_fast") == fast_cfg, f"base serving config {cfg}")
            fast = api.bundle_from_jax(fast_cfg, *weights.init_jax_layout(cfg, 0), device=dev)
            same = bool(torch.equal(serve.model.encode(serve.params, serve.rvq, wav),
                                    fast.model.encode(fast.params, fast.rvq, wav)))
            emit({"phase": "configs", "config": name, "what": "serving_is_base_fast",
                  "activation": cfg.activation, "indices_equal": same})
            check(same, "base serving: indices differ from base_fast's serving bundle on the "
                  "same weights")
            del fast
        else:
            # base serves base_fast's computation on base_fast's shapes, which
            # the main path times; every other configuration is timed here
            rec["reconstruct"] = reconstruct_rtf(serve, wav)
            rec["kernels"] = config_kernels(serve, wav, events_ms)
            emit({"phase": "configs", "config": name, "what": "kernels", **rec["kernels"],
                  "card": card})
        f32 = api.load_model(name, device=dev)
        rec["float32"] = config_float32(name, f32, serve, wav_np[:CONFIG_F32_ROWS])
        emit({"phase": "configs", "config": name, "what": "float32_card_vs_cpu", **rec["float32"]})
        del f32
        rec["streaming"] = config_streaming(serve, wav_np)
        emit({"phase": "configs", "config": name, "what": "streaming", **rec["streaming"]})
        by_path[f"{name}_streaming"] = rec["streaming"]["launches"]
        del serve
        torch.cuda.empty_cache()
        with torch.enable_grad():
            rec["training"] = config_training(dev, name, card)
        emit({"phase": "configs", "config": name, "what": "training", **rec["training"]})
        by_path[f"{name}_training"] = rec["training"]["launches"]
        rec["seconds"] = time.perf_counter() - t0
        kern = rec.get("kernels", {})
        emit({"phase": "timing", "what": "configs", "config": name, "seconds": rec["seconds"],
              "reconstruct": rec.get("reconstruct", "base_fast's (the main path)"),
              "batch": int(wav.shape[0]),
              "kernel_ms": {k: v["ms"] for k, v in kern.items()},
              "kernel_bound_ms": {k: v["bound_ms"] for k, v in kern.items()},
              "step_event_ms": rec["training"]["step_event_ms"],
              "peak_memory_gb": rec["training"]["peak_memory_gb"], "card": card})
        rows[name] = rec
    del wav
    torch.cuda.empty_cache()
    default = get_config("base").name
    base = api.load_model(default, device=dev)
    emit({"phase": "configs", "what": "cli_default_model", "model": default,
          **cli_roundtrip(base, [], exact=False)})
    return by_path, rows


def small_trained_smoke(dev, card, events_ms) -> dict:
    """The `small_trained` phase on SMALL_EXPORT: the fingerprint in
    meta.json; the float32 path's indices on both 8 x 10 s probes against
    nsc_tpu's CPU reference (reference_f32.npz) by the margin rule; the
    serving path run to run and against its GPU pin (exact when the pin's
    backend is this run's); the float32 and serving sweeps (`sweep_smoke`:
    the rows against reference_sweep.json at every depth, the serving
    sweep's launches); one CLI round trip of the serving bundle. Returns the serving sweep's
    launch counts."""
    import numpy as np

    from nsc_tpu_torch import api, canonical
    from nsc_tpu_torch.train import checkpoint as ckpt

    meta = ckpt.export_meta(SMALL_EXPORT)
    serve = api.load_model("small", checkpoint=SMALL_EXPORT, serving=True, device=dev)
    f32 = api.load_model("small", checkpoint=SMALL_EXPORT, device=dev)
    fps = (api.codebook_fingerprint(serve.rvq), api.codebook_fingerprint(f32.rvq))
    emit({"phase": "small_trained", "what": "load", "export": os.path.relpath(SMALL_EXPORT),
          "meta": meta, "fingerprints": fps, "route": serve.model.kernels.units})
    check(fps == (meta["fingerprint"], meta["fingerprint"]), f"small fingerprint {fps} != {meta}")
    probes = {"noise": canonical.probe_input(f32.cfg), "speech": canonical.speech_probe_input(f32.cfg)}
    with np.load(os.path.join(SMALL_EXPORT, "reference_f32.npz"), allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    check(int(ref["fingerprint"]) == meta["fingerprint"], "small reference_f32.npz: other codebooks")
    for name, x in probes.items():
        rec = first_flips(api.encode(f32, x), ref[f"indices_{name}"], ref[f"margins_{name}"])
        emit({"phase": "small_trained", "what": "float32_vs_nsc_tpu_cpu_reference", "probe": name,
              "rows": x.shape[0], **rec})
        check(rec["ok"], f"small float32 {name} probe: an index differs from nsc_tpu's where its "
              f"margin is not below {K2_NEAR_TIE}")
    del f32
    first = api.encode(serve, probes["speech"])
    again = api.encode(serve, probes["speech"])
    exact, rate, status, gated = canonical.check_pin(serve, SMALL_EXPORT)
    emit({"phase": "small_trained", "what": "serving_determinism",
          "run_to_run_equal": bool(np.array_equal(first, again)), "pin_exact": exact,
          "pin_match_rate": rate, "pin_status": status, "backend": canonical.backend(dev),
          "pin_gated": gated})
    check(np.array_equal(first, again), "small serving path: two encodes of the probe differ")
    check(exact is not None, f"small GPU pin: {status}")
    if gated:
        check(exact, f"small serving path misses its GPU pin: {rate} ({status})")
    launches = sweep_smoke(dev, serve, card, events_ms, SMALL_EXPORT, "small", "small_trained",
                           require_all=True)
    emit({"phase": "small_trained", "what": "cli",
          **cli_roundtrip(serve, ["--model", "small", "--checkpoint", SMALL_EXPORT, "--serving"],
                          exact=True)})
    return launches


def main() -> int:
    t_start = time.perf_counter()
    # cuBLAS reads its workspace setting once; deterministic() needs this one
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    import numpy as np

    from nsc_tpu_torch import api, bitstream, kernels, weights
    from nsc_tpu_torch.kernels import _build
    from nsc_tpu_torch.kernels import fused_stage as FS
    from nsc_tpu_torch.kernels import residual_stack as RS
    from nsc_tpu_torch.kernels import rvq as KR
    from nsc_tpu_torch.models import seanet
    from nsc_tpu_torch.ops import rvq as rvq_ops
    from nsc_tpu_torch.ops.precision import float32_numerics

    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)

    # 1. device -------------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                   "matmul": torch.backends.cuda.matmul.allow_tf32}})

    # 2. build --------------------------------------------------------------
    _build.library()
    # ptxas's resource lines (registers, shared memory, spills) per compiled
    # kernel, and the HMMA instructions of each stage-kernel instantiation
    ptxas, spills, name = [], {}, "?"
    for ln in _build.build_log.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_label(ln)
        elif "spill stores" in ln:
            spills[name] = [int(v) for v in re.findall(r"(\d+) bytes spill", ln)]
        elif "Used" in ln and "registers" in ln:
            ptxas.append(f"{name}: {ln.split(': ', 1)[-1]}")
    hmma = hmma_counts(_build.library()._name, os.path.dirname(_build.nvcc()))
    emit({"phase": "build", "seconds": round(_build.build_seconds, 3), "ptxas": ptxas,
          "spills": spills, "hmma": hmma})
    for label, (stores, loads) in spills.items():
        if label.startswith(STAGE_KERNELS + ("stft_magnitude",)):
            check(stores == 0 and loads == 0, f"ptxas: {label} spills registers")
    if ptxas:  # K4's cluster kernel, one instantiation per cluster size, each read
        for c in (2, 4, 8):
            check(f"stft_magnitude_bluestein_cluster<{c}>" in spills,
                  f"ptxas: no line for stft_magnitude_bluestein_cluster<{c}>")
        for part in ("cross_dif", "share", "cross_dit", "end"):  # and the two-level route's four
            check(f"stft_magnitude_bluestein_global_{part}" in spills,
                  f"ptxas: no line for stft_magnitude_bluestein_global_{part}")
    for label, n in hmma.items():
        if "<f32" in label:
            check(n == 0, f"{label}: {n} HMMA in a float32 instantiation")
        elif label.endswith(",tc>"):
            check(n > 0, f"{label}: no HMMA in a tensor-core instantiation")
    for kernel in STAGE_KERNELS:
        check(hmma.get(f"{kernel}<bf16,snake_fast,tc>", 0) > 0,
              f"{kernel}: no tensor-core instantiation in the library")
    for plan in ("resident", "streamed"):
        check(hmma.get(f"rvq_quantize<{plan}>", 0) > 0,
              f"rvq_quantize: no HMMA in the {plan} plan's kernel")
    # K2's two plans after the rescoring: the resident plan must not spill
    k2_plans = {plan: {"ptxas": [ln for ln in ptxas if ln.startswith(f"rvq_quantize<{plan}>")],
                       "spill_bytes": spills.get(f"rvq_quantize<{plan}>")}
                for plan in ("resident", "streamed")}
    emit({"phase": "build", "kernel": "rvq_quantize", "plans": k2_plans,
          "library": "built here" if ptxas else "reused (no ptxas output)"})
    if ptxas:
        check(k2_plans["resident"]["spill_bytes"] == [0, 0],
              f"rvq_quantize<resident> spills: {k2_plans['resident']}")

    def events_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    # the model, its inputs, and the 8 stage shapes of the main path
    bundle = api.load_model("base_fast", serving=True, device=dev)
    cfg, model, params, rvq = bundle.cfg, bundle.model, bundle.params, bundle.rvq
    # the opt-in serving paths as a user selects them: the serving config
    # with another unit_backend, the same seed-0 weights
    bundles = {"serving": bundle}
    for path, backend, route in SERVING_PATHS[1:]:
        c = dataclasses.replace(cfg, unit_backend=backend)
        bundles[path] = api.bundle_from_jax(c, *weights.init_jax_layout(c, 0), device=dev)
        check(bundles[path].model.kernels.units == route, f"{path}: route {bundles[path].model.kernels}")
    t_len = int(SECONDS * cfg.sample_rate)
    wav_np = np.random.RandomState(0).randn(BATCH, t_len).astype(np.float32) * 0.1
    wav = torch.from_numpy(wav_np).to(dev)
    stages = stage_list(cfg, t_len)
    fast = cfg.activation == "snake_fast"
    dil = tuple(cfg.dilations)

    def stage_params(path, st):
        return bundles[path].params[st["part"]]["stages"][st["i"]]

    # K6's and K5's packed stages in float32 (K5's head and tail weights
    # too, the unit weights without planes) for the float32 checks; the bf16
    # ones are the serving bundles' own
    packed_f32 = {}
    for route, key in (("residual_stack_cl", "stack_cl"), ("fused_stage", "fused")):
        for part in ("encoder", "decoder"):
            copies = [dict(st) for st in params[part]["stages"]]
            seanet.pack_stages(part, copies, route, torch.float32, fast)
            packed_f32[key, part] = [st[key] for st in copies]

    # 3. kernels against their plain versions -------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    def compare(kernel, st, dname, got, ref):
        return stage_error(got, ref, dname, f"{kernel} {st['name']} {dname}",
                           1 if kernel == "residual_stack_cl" else -1, kernel=kernel,
                           stage=st["name"], B=BATCH, in_shape=list(got.shape))["max_abs_err"]

    stage_err = {"residual_stack": 0.0, "residual_stack_cl": 0.0, "fused_stage": 0.0}
    for st in stages:
        c, t = st["units_ct"]
        c_in, t_in = st["in_ct"]
        x32 = torch.randn(BATCH, c, t, device=dev, generator=gen) * 0.5
        xh32 = (torch.randn(BATCH, c_in, t_in, device=dev, generator=gen) * 0.5
                if (c_in, t_in) != (c, t) else x32)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            # K1 (B, C, T), weights in x's dtype
            packed = RS.pack_stage(stage_params("serving", st)["units"], dtype)
            got = RS.residual_stack(x, packed, dil, fast)
            torch.cuda.synchronize()
            err = compare("residual_stack", st, dname, got, RS.residual_stack_plain(x, packed, dil, fast))
            # K6 (B, T, C), float32 weights
            xt = x.transpose(1, 2).contiguous()
            p6 = (stage_params("serving_channels_last", st)["stack_cl"] if dtype == torch.bfloat16
                  else packed_f32["stack_cl", st["part"]][st["i"]])
            got = RS.residual_stack_cl(xt, p6, dil, fast)
            torch.cuda.synchronize()
            err6 = compare("residual_stack_cl", st, dname, got,
                           RS.residual_stack_cl_plain(xt, p6, dil, fast))
            del got, xt
            # K5 with the stage's real head or tail
            xh = xh32.to(dtype)
            p5 = (stage_params("serving_fused_boundary", st)["fused"] if dtype == torch.bfloat16
                  else packed_f32["fused", st["part"]][st["i"]])
            got = FS.fused_stage(xh, p5, dil, fast)
            torch.cuda.synchronize()
            err5 = compare("fused_stage", st, dname, got, FS.fused_stage_plain(xh, p5, dil, fast))
            if dtype == torch.bfloat16:
                for kernel, e in (("residual_stack", err), ("residual_stack_cl", err6),
                                  ("fused_stage", err5)):
                    stage_err[kernel] = max(stage_err[kernel], e)
            del got, x, xh
        del x32, xh32

    books = rvq["codebooks"].contiguous()
    z = model.latents(params, wav)  # the main path's own latents
    z2d = z.reshape(-1, z.shape[-1]).float().contiguous()
    idx_k = KR.quantize(books, z2d)
    torch.cuda.synchronize()
    with float32_numerics():
        idx_p = KR.quantize_plain(books, z2d)
    rec = index_check(books, z2d, idx_k, idx_p)
    worst_margin = rec["worst_first_mismatch_margin"]
    emit({"phase": "kernel_check", "kernel": "rvq_quantize", "M": z2d.shape[0],
          "n_q": books.shape[0], "K": books.shape[1], "D": books.shape[2], **rec})
    check(rec["near_ties"] == rec["frames_differing"],
          "K2: an index differs where the plain version's margin is not a near-tie")
    # K2's launch plan, and its winning scores against float64 scores of the
    # same (frame, book, index): the float32 residual as the kernel forms it,
    # the dot in float64; beside them the plain version's own winning scores
    plan = KR.quantize_plan(*z2d.shape)
    idx_s, best_k = KR.quantize_with_scores(books, z2d)
    check(torch.equal(idx_s, idx_k), "K2: two launches on the same input disagree")
    csq = KR.codeword_sq_norms(books)
    with float32_numerics():
        r, best_p = z2d, []
        for q in range(books.shape[0]):
            sc = csq[q][None, :] - 2.0 * (r @ books[q].t())
            best_p.append(sc.gather(1, idx_p[:, q:q + 1].long())[:, 0])
            r = r - books[q][idx_p[:, q].long()]
            del sc
        best_p = torch.stack(best_p, dim=1)
    k2_scores = {"kernel": k2_score_err(books, z2d, idx_k, best_k),
                 "plain": k2_score_err(books, z2d, idx_p, best_p)}
    emit({"phase": "kernel_check", "kernel": "rvq_quantize", "plan": plan,
          "score_abs_err_vs_float64": k2_scores})
    check(k2_scores["kernel"]["max_ulps"] <= K2_SCORE_ULPS,
          f"K2's winning scores lie {k2_scores['kernel']['max_ulps']} float32 ulps from float64")
    del idx_s, best_k, best_p, r
    # K2's first launch, the codebook split, against its plain version
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    kp, dp = KR.padded_shape(*books.shape[1:])
    planes = torch.empty(books.shape[0], 3, kp, dp, dtype=torch.bfloat16, device=dev)

    def split_launch():
        _build.check(lib.nsc_rvq_split_planes(books.data_ptr(), planes.data_ptr(), *books.shape,
                                              kp, dp, stream), "nsc_rvq_split_planes")

    split_launch()
    torch.cuda.synchronize()
    split_exact = torch.equal(planes.view(torch.int16), KR.codebook_planes(books).view(torch.int16))
    emit({"phase": "kernel_check", "kernel": "rvq_split_planes", "shape": list(planes.shape),
          "bit_exact": split_exact})
    check(split_exact, "rvq_split_planes: not bit-exact against its plain version")

    # K2's streamed plan (padded widths over 128) on N(0, 1) books and frames
    gw = torch.Generator(device=dev).manual_seed(7)
    wide = []
    for n_q_w, k_w, d_w in K2_WIDE:
        bk = torch.randn(n_q_w, k_w, d_w, device=dev, generator=gw)
        zz = torch.randn(K2_WIDE_M, d_w, device=dev, generator=gw)
        wplan = KR.quantize_plan(K2_WIDE_M, d_w)
        got = KR.quantize(bk, zz)
        torch.cuda.synchronize()
        with float32_numerics():
            ref = KR.quantize_plain(bk, zz)
        rec = index_check(bk, zz, got, ref)
        emit({"phase": "kernel_check", "kernel": "rvq_quantize", "M": K2_WIDE_M, "n_q": n_q_w,
              "K": k_w, "D": d_w, "plan": wplan, **rec})
        check(wplan["plan"] == "streamed" and wplan["smem_bytes"] <= RS.MAX_SMEM,
              f"K2 at D={d_w}: plan {wplan}")
        check(tuple(got.shape) == (K2_WIDE_M, n_q_w) and int(got.min()) >= 0 and int(got.max()) < k_w,
              f"K2 at D={d_w}: indices out of shape or range")
        check(rec["near_ties"] == rec["frames_differing"],
              f"K2 at D={d_w}: an index differs where the plain version's margin is not a near-tie")
        wide.append({"n_q": n_q_w, "K": k_w, "D": d_w, "M": K2_WIDE_M, "books": bk, "z": zz,
                     "check": rec})
        del got, ref

    # K3: the serving shape, a ragged M, an odd D (4-byte rows), indices
    # outside [0, K) (they add nothing), all bit-exact against the plain
    # version; and the earlier row-warp design, timed beside it below, on the serving
    # indices
    deq_k = KR.dequantize(books, idx_p)
    torch.cuda.synchronize()
    with float32_numerics():
        deq_p = KR.dequantize_plain(books, idx_p)
    deq_err = (deq_k - deq_p).abs().max().item()
    emit({"phase": "kernel_check", "kernel": "rvq_dequantize", "M": idx_p.shape[0],
          "bit_exact": bool(torch.equal(deq_k, deq_p)), "max_abs_err": deq_err})
    check(torch.equal(deq_k, deq_p), "K3: not bit-exact against its plain version")
    n_q, k, d = books.shape
    out_old = torch.empty_like(deq_k)

    def dequantize_rowwarp():
        _build.check(lib.nsc_rvq_dequantize_rowwarp(idx_p.data_ptr(), books.data_ptr(),
                                                    out_old.data_ptr(), *idx_p.shape, k, d, stream),
                     "nsc_rvq_dequantize_rowwarp")

    out_of_range = idx_p.clone()
    out_of_range[::3, 0] = -1
    out_of_range[1::2, -1] = k
    out_of_range[::5, n_q // 2] = 1 << 30
    odd_books = torch.randn(n_q, k, d + 1, device=dev, generator=gw)
    for what, bk, ii in (("ragged_M", books, idx_p[:1001].contiguous()),
                         ("odd_D", odd_books, idx_p),
                         ("out_of_range", books, out_of_range)):
        got = KR.dequantize(bk, ii)
        torch.cuda.synchronize()
        with float32_numerics():
            ref = KR.dequantize_plain(bk, ii)
        exact = bool(torch.equal(got, ref))
        emit({"phase": "kernel_check", "kernel": "rvq_dequantize", "case": what,
              "M": ii.shape[0], "n_q": bk.shape[0], "K": bk.shape[1], "D": bk.shape[2],
              "bit_exact": exact})
        check(exact, f"K3 {what}: not bit-exact against its plain version")
        del got, ref
    dequantize_rowwarp()
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "kernel": "rvq_dequantize", "case": "row-warp design",
          "bit_exact": bool(torch.equal(out_old, deq_p))})
    check(torch.equal(out_old, deq_p), "K3's row-warp design: not bit-exact against the plain version")
    del out_of_range, odd_books

    # 4. main path ----------------------------------------------------------
    # each serving path once, the counters read around its reconstruct
    serving_launches = {}
    for path, backend, route in SERVING_PATHS:
        b = bundles[path]
        kernels.reset_launches()
        out = b.model.reconstruct(b.params, b.rvq, wav)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        emit({"phase": "main", "what": "reconstruct", "path": path, "unit_backend": backend,
              "shape": list(out.shape), "finite": bool(torch.isfinite(out).all().item()),
              "launches": launches})
        check(tuple(out.shape) == (BATCH, t_len), f"{path}: reconstruct shape {tuple(out.shape)}")
        check(torch.isfinite(out).all().item(), f"{path}: reconstruct output not finite")
        expect = dict.fromkeys(kernels.LAUNCHES, 0)
        expect.update({route: 8, "rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1})
        check(launches == expect, f"{path}: launch counts {launches}, expected {expect}")
        serving_launches[path] = launches
        del out

    one = wav_np[0]
    idx_one = api.encode(bundle, one)
    rt = {}
    for entropy in (False, True):
        blob = api.compress(bundle, one, entropy_coding=entropy)
        header, idx_back = bitstream.deserialize(blob)
        back = api.decompress(bundle, blob)
        rt["entropy" if entropy else "raw"] = {
            "bytes": len(blob), "indices_equal": bool(np.array_equal(idx_back, idx_one)),
            "wav_shape": list(back.shape), "finite": bool(np.isfinite(back).all())}
        check(np.array_equal(idx_back, idx_one), "compress/decompress indices differ")
        check(back.shape == one.shape and np.isfinite(back).all(), "decompress output")
    emit({"phase": "main", "what": "compress_roundtrip", "frames": int(idx_one.shape[0]),
          "n_q": int(idx_one.shape[1]), **rt})

    # drift, reported and not gated: each serving path against the float32
    # path (PyTorch's default TF32 settings: the codec turns TF32 off itself)
    # and the opt-in paths against "auto"
    f32 = api.load_model("base_fast", serving=False, device=dev)
    idx_f = f32.model.encode(f32.params, f32.rvq, wav)
    dec_f = f32.model.decode(f32.params, f32.rvq, idx_f)
    lat_f = f32.model.latents(f32.params, wav)
    margins = rvq_ops.argmin_margins(f32.rvq, lat_f).flatten()

    idx_auto = model.encode(params, rvq, wav)
    dec_auto = model.decode(params, rvq, idx_f)
    for path, backend, _ in SERVING_PATHS:
        b = bundles[path]
        idx_s = b.model.encode(b.params, b.rvq, wav) if path != "serving" else idx_auto
        dec_s = b.model.decode(b.params, b.rvq, idx_f) if path != "serving" else dec_auto
        rec = {"phase": "main", "what": "serving_vs_float32", "path": path,
               **drift(idx_s, idx_f, dec_s, dec_f)}
        if path == "serving":
            rec["float32_argmin_margin_percentiles"] = {
                p: torch.quantile(margins.double(), p / 100).item() for p in (0, 1, 5, 50)}
        else:
            rec["vs_auto"] = drift(idx_s, idx_auto, dec_s, dec_auto)
        emit(rec)
        del idx_s, dec_s
    del f32, idx_f, dec_f, lat_f, idx_auto, dec_auto

    # 5. timing -------------------------------------------------------------
    rtf = {}
    for path, backend, _ in SERVING_PATHS:
        b = bundles[path]
        rec = reconstruct_rtf(b, wav)
        ev_ms = events_ms(lambda: b.model.reconstruct(b.params, b.rvq, wav), reps=3)
        rtf[path] = rec["rtf"]
        emit({"phase": "timing", "what": "reconstruct", "path": path, "unit_backend": backend,
              "batch": BATCH, "seconds": SECONDS, **rec, "event_ms": ev_ms, "card": card})

    def add(acc, ms, plain_ms, bytes_ms, ops_ms):
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", bytes_ms),
                       ("ops_ms", ops_ms), ("bound_ms", max(bytes_ms, ops_ms))):
            acc[key] += v

    def nbytes(*tensors):
        return sum(v.numel() * v.element_size() for v in tensors)

    timing = {k: dict.fromkeys(("ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms"), 0.0)
              for k in ("residual_stack", "residual_stack_cl", "fused_stage")}
    for st in stages:
        c, t = st["units_ct"]
        x = (torch.randn(BATCH, c, t, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
        # K1: bf16 products on the tensor cores' rate
        p = stage_params("serving", st)["stack"]
        ms = events_ms(lambda: RS.residual_stack(x, p, dil, fast))
        plain_ms = events_ms(lambda: RS.residual_stack_plain(x, p, dil, fast), reps=3)
        b_ms, o_ms, unit_flops = k1_bound(x, p, dil)
        emit({"phase": "timing", "kernel": "residual_stack", "stage": st["name"], "C": c, "T": t,
              "ms": ms, "plain_ms": plain_ms, "flops": unit_flops, "bound_ms": max(b_ms, o_ms),
              "bound_by": "bytes" if b_ms > o_ms else "operations"})
        add(timing["residual_stack"], ms, plain_ms, b_ms, o_ms)
        # K6: float32 weights, each product float32-exact as three bf16
        # MMAs (the kernel reads the weights' bf16 planes): 3 x unit_flops
        # at the bf16 rate
        xt = x.transpose(1, 2).contiguous()
        p = stage_params("serving_channels_last", st)["stack_cl"]
        ms = events_ms(lambda: RS.residual_stack_cl(xt, p, dil, fast))
        plain_ms = events_ms(lambda: RS.residual_stack_cl_plain(xt, p, dil, fast), reps=3)
        b_ms, o_ms, _ = k1_bound(x, p, dil, products=3)
        emit({"phase": "timing", "kernel": "residual_stack_cl", "stage": st["name"], "C": c,
              "T": t, "ms": ms, "plain_ms": plain_ms, "flops": unit_flops,
              "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms > o_ms else "operations"})
        add(timing["residual_stack_cl"], ms, plain_ms, b_ms, o_ms)
        del xt
        # K5: units as K6 (3 x unit_flops), head and tail (weights in bf16)
        # one MMA per product, all at the bf16 rate; bytes are the stage's
        # input, output and the weights the kernel reads
        c_in, t_in = st["in_ct"]
        xh = x if (c_in, t_in) == (c, t) else (
            torch.randn(BATCH, c_in, t_in, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
        p = stage_params("serving_fused_boundary", st)["fused"]
        ms = events_ms(lambda: FS.fused_stage(xh, p, dil, fast))
        out = FS.fused_stage(xh, p, dil, fast)
        plain_ms = events_ms(lambda: FS.fused_stage_plain(xh, p, dil, fast), reps=3)
        edge_flops = 0
        if "head" in p:
            edge_flops += 2 * BATCH * t * p["head"]["w"].numel()
        if "tail" in p:
            edge_flops += 2 * BATCH * t * p["tail"]["w"].numel()
        weight_bytes = nbytes(*p["units"].values()) + sum(
            nbytes(*p[k].values()) for k in ("head", "tail") if k in p)
        b_ms = (nbytes(xh) + nbytes(out) + weight_bytes) / PEAK_BYTES * 1e3
        o_ms = (3 * unit_flops + edge_flops) / PEAK_BF16_FLOPS * 1e3
        emit({"phase": "timing", "kernel": "fused_stage", "stage": st["name"],
              "in_shape": list(xh.shape), "out_shape": list(out.shape), "ms": ms,
              "plain_ms": plain_ms, "unit_flops": unit_flops, "edge_flops": edge_flops,
              "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms > o_ms else "operations"})
        add(timing["fused_stage"], ms, plain_ms, b_ms, o_ms)
        del x, xh, out
    for kernel, acc in timing.items():
        emit({"phase": "timing", "kernel": kernel, "per": "reconstruct (8 launches)", **acc,
              "card": card})

    m = z2d.shape[0]
    q_ms = events_ms(lambda: KR.quantize(books, z2d), reps=20)
    q_plain = events_ms(lambda: KR.quantize_plain(books, z2d))
    # beside K2's bound the float32-rate bound of one float32 product, as
    # earlier slices gave it
    q_flops = 2 * m * k * d * n_q
    q_bytes_ms, q_ops_ms = k2_bound(books, m)
    q_f32_ms = max(q_bytes_ms, q_flops / PEAK_F32_FLOPS * 1e3)

    # K2's streamed plan, bound as the resident one
    for w in wide:
        bk, zz = w["books"], w["z"]
        w_bytes_ms, w_ops_ms = k2_bound(bk, w["M"])
        w.update(ms=events_ms(lambda: KR.quantize(bk, zz)),
                 plain_ms=events_ms(lambda: KR.quantize_plain(bk, zz)),
                 bound_ms=max(w_bytes_ms, w_ops_ms),
                 bound_by="bytes" if w_bytes_ms > w_ops_ms else "operations")
        del w["books"], w["z"]
        emit({"phase": "timing", "kernel": "rvq_quantize", "plan": "streamed", **w, "card": card})
    del bk, zz

    # the codebook split: each value read once and its three planes written
    # once; two float32 subtractions per value
    sp_ms = events_ms(split_launch, reps=20)
    sp_plain = events_ms(lambda: KR.codebook_planes(books))
    sp_bytes_ms = (books.numel() * 4 + planes.numel() * 2) / PEAK_BYTES * 1e3
    sp_ops_ms = 2 * books.numel() / PEAK_F32_FLOPS * 1e3

    # K3 and the row-warp design in turns (kernel, row-warp, row-warp, kernel), 50
    # launches each; its L2 gather floor: the codewords it gathers,
    # n_q * D * 4 bytes a frame, over the L2 read rate of one reduction of an
    # 8 MB tensor repeated L2_PROBE_REPEATS times (a stride-0 view: each
    # repeat reads the same bytes, which stay in L2)
    turns = [events_ms(fn, reps=50) for fn in (lambda: KR.dequantize(books, idx_p),
                                               dequantize_rowwarp, dequantize_rowwarp,
                                               lambda: KR.dequantize(books, idx_p))]
    dq_ms, dq_old_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    dq_plain = events_ms(lambda: KR.dequantize_plain(books, idx_p))
    flat = books.reshape(n_q * k, d)
    offs = idx_p.long() + torch.arange(n_q, device=dev)[None, :] * k
    dq_lib = events_ms(lambda: torch.nn.functional.embedding_bag(offs, flat, mode="sum"), reps=50)
    dq_bytes_ms, dq_ops_ms = k3_bound(books, idx_p)
    l2_src = torch.rand(L2_PROBE_FLOATS, device=dev, generator=gen)
    l2_view = l2_src.expand(L2_PROBE_REPEATS, L2_PROBE_FLOATS)
    l2_ms = events_ms(lambda: l2_view.sum(1), reps=20)
    l2_rate = L2_PROBE_REPEATS * L2_PROBE_FLOATS * 4 / (l2_ms * 1e-3)
    dq_gathered = n_q * d * 4 * m
    dq_floor_ms = dq_gathered / l2_rate * 1e3
    emit({"phase": "timing", "kernel": "rvq", "quantize_ms": q_ms,
          "quantize_plain_ms": q_plain, "quantize_bound_ms": max(q_bytes_ms, q_ops_ms),
          "quantize_float32_rate_bound_ms": q_f32_ms, "quantize_plan": plan,
          "split_planes_ms": sp_ms, "split_planes_plain_ms": sp_plain,
          "split_planes_bound_ms": max(sp_bytes_ms, sp_ops_ms),
          "dequantize_ms": dq_ms, "dequantize_turns_ms": turns,
          "dequantize_rowwarp_ms": dq_old_ms,
          "dequantize_plain_ms": dq_plain, "dequantize_library_ms": dq_lib,
          "dequantize_bound_ms": max(dq_bytes_ms, dq_ops_ms),
          "dequantize_gathered_bytes": dq_gathered, "l2_probe_ms": l2_ms,
          "l2_read_bytes_per_s": l2_rate, "dequantize_l2_gather_floor_ms": dq_floor_ms,
          "dequantize_achieved_l2_bytes_per_s": dq_gathered / (dq_ms * 1e-3),
          "card": card})
    del out_old, l2_src, l2_view

    del bundle, bundles, model, params, rvq, wav, books, z, z2d, idx_k, idx_p, deq_k, deq_p, planes
    torch.cuda.empty_cache()

    # the trained flagship, streaming on it, and the CLI --------------------
    t_phase = time.perf_counter()
    serve, f32, flagship_launches = flagship_smoke(dev, wav_np)
    t_int8 = time.perf_counter()
    qserve, int8_launches, int8_summary = int8_smoke(dev, serve, f32, wav_np, card, events_ms)
    stacked_rtf = stacked_smoke(dev, f32, wav_np, card)
    wav = torch.from_numpy(wav_np).to(dev)
    serving_rtf = {"auto": reconstruct_rtf(serve, wav), "int8": reconstruct_rtf(qserve, wav)}
    emit({"phase": "timing", "what": "reconstruct", "bundle": "flagship serving",
          "batch": BATCH, "seconds": SECONDS, **serving_rtf, "card": card})
    del wav
    t_stream = time.perf_counter()
    streaming_launches = streaming_smoke(serve, f32, card, events_ms)
    del f32
    t_cli = time.perf_counter()
    join_plain_bases = plain_basis_prefetch()
    cli_smoke(serve, qserve)
    t_wait = time.perf_counter()
    basis_seconds = join_plain_bases()
    emit({"phase": "timing", "what": "plain_basis_prefetch", "beside": "cli",
          "cli_seconds": t_wait - t_cli, "wait_seconds": time.perf_counter() - t_wait,
          "build_seconds": basis_seconds})
    t_trace = time.perf_counter()
    trace_smoke(serve, qserve, wav_np, card)
    doctor_smoke(card)
    t_sweep = time.perf_counter()
    sweep_launches = sweep_smoke(dev, serve, card, events_ms)
    t_native = time.perf_counter()
    native_smoke(serve, wav_np, card)
    emit({"phase": "timing", "what": "sweep_native", "sweep_seconds": t_native - t_sweep,
          "native_seconds": time.perf_counter() - t_native})
    emit({"phase": "timing", "what": "flagship_int8_stacked_streaming_cli_trace_doctor",
          "flagship_seconds": t_int8 - t_phase, "int8_and_stacked_seconds": t_stream - t_int8,
          "streaming_seconds": t_cli - t_stream, "cli_seconds": t_wait - t_cli,
          "trace_and_doctor_seconds": time.perf_counter() - t_trace})
    del serve, qserve
    torch.cuda.empty_cache()

    with torch.enable_grad():
        k4_summaries, train_launches, step_ms, k4_global_launches = train_smoke(dev, card,
                                                                                events_ms)
        t_k4_any = time.perf_counter()
        k4_any_launches = k4_bank_smoke(dev, card, events_ms, "k4_any", K4_ANY_BANK, K4_ANY_MEL)
        t_k4_chirp = time.perf_counter()
        k4_chirp_launches = k4_bank_smoke(dev, card, events_ms, "k4_chirp", K4_CHIRP_BANK,
                                          K4_CHIRP_MEL)
        t_k4_cluster = time.perf_counter()
        k4_cluster_launches = k4_bank_smoke(dev, card, events_ms, "k4_cluster", K4_CLUSTER_BANK,
                                            K4_CLUSTER_MEL)
    emit({"phase": "timing", "what": "k4_any", "seconds": t_k4_chirp - t_k4_any})
    emit({"phase": "timing", "what": "k4_chirp", "seconds": t_k4_cluster - t_k4_chirp})
    emit({"phase": "timing", "what": "k4_cluster", "seconds": time.perf_counter() - t_k4_cluster})
    t_dp = time.perf_counter()
    with torch.enable_grad():
        dp_launches = dp_smoke(dev, card, step_ms)
    emit({"phase": "timing", "what": "dp", "seconds": time.perf_counter() - t_dp})

    # the training loop, the refit and the finetune; serving their workdirs
    import shutil
    import tempfile

    wav = torch.from_numpy(wav_np).to(dev)
    tmp = tempfile.mkdtemp(prefix="nsc_loop_")
    try:
        t0 = time.perf_counter()
        with torch.enable_grad():
            loop_launches, loop_serving = loop_smoke(dev, wav, tmp, step_ms, card)
        t1 = time.perf_counter()
        refit_launches = refit_smoke(dev, card)
        t2 = time.perf_counter()
        with torch.enable_grad():
            finetune_launches, finetune_serving = finetune_smoke(dev, wav, tmp, card)
        t3 = time.perf_counter()
        torch.cuda.empty_cache()
        close_launches, close_training = close_smoke(dev, wav, tmp, card)
        emit({"phase": "timing", "what": "loop_refit_finetune_close", "loop_seconds": t1 - t0,
              "refit_seconds": t2 - t1, "finetune_seconds": t3 - t2,
              "close_seconds": time.perf_counter() - t3})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del wav
    torch.cuda.empty_cache()

    # every other registered configuration, and the trained small export
    t_configs = time.perf_counter()
    configs_launches, config_rows = configs_smoke(dev, wav_np, card, events_ms)
    t_small = time.perf_counter()
    small_launches = small_trained_smoke(dev, card, events_ms)
    emit({"phase": "timing", "what": "configs_small_trained",
          "configs_seconds": t_small - t_configs,
          "small_trained_seconds": time.perf_counter() - t_small})

    by_path = {**serving_launches, "flagship": flagship_launches, "int8": int8_launches,
               "streaming": streaming_launches, "training": train_launches,
               "training_loop": loop_launches, "training_loop_serving": loop_serving,
               "refit": refit_launches, "finetune": finetune_launches,
               "finetune_serving": finetune_serving, "dp": dp_launches,
               "sweep": sweep_launches, "k4_any": k4_any_launches,
               "k4_chirp": k4_chirp_launches, "k4_cluster": k4_cluster_launches,
               "k4_global_loss": k4_global_launches, "close": close_launches,
               "close_training": close_training, **configs_launches,
               "small_trained_sweep": small_launches}

    def stage_entry(kernel, source, replaces):
        acc = timing[kernel]
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": stage_err[kernel], "ms": acc["ms"], "plain_ms": acc["plain_ms"],
                "bound_ms": acc["bound_ms"],
                "bound_by": "bytes" if acc["bytes_ms"] > acc["ops_ms"] else "operations",
                "library_ms": None}

    summary = {"kernels": [
        stage_entry("residual_stack", "nsc_tpu_torch/csrc/residual_stack.cu",
                    "nsc_tpu/ops/pallas/residual_stack.py:305"),
        {"name": "rvq_quantize", "route": "cuda", "source": "nsc_tpu_torch/csrc/rvq.cu",
         "replaces": "nsc_tpu/ops/pallas/rvq_argmin.py:90", "max_abs_err": worst_margin,
         "ms": q_ms, "plain_ms": q_plain, "bound_ms": max(q_bytes_ms, q_ops_ms),
         "bound_by": "bytes" if q_bytes_ms > q_ops_ms else "operations",
         "library_ms": None,
         "streamed": [{key: w[key] for key in ("n_q", "K", "D", "M", "ms", "plain_ms", "bound_ms")}
                      for w in wide]},
        {"name": "rvq_split_planes", "route": "cuda", "source": "nsc_tpu_torch/csrc/rvq.cu",
         "replaces": "nsc_tpu/ops/pallas/rvq_argmin.py:90", "max_abs_err": 0.0,
         "ms": sp_ms, "plain_ms": sp_plain, "bound_ms": max(sp_bytes_ms, sp_ops_ms),
         "bound_by": "bytes" if sp_bytes_ms > sp_ops_ms else "operations", "library_ms": None},
        {"name": "rvq_dequantize", "route": "cuda", "source": "nsc_tpu_torch/csrc/rvq.cu",
         "replaces": "nsc_tpu/ops/pallas/rvq_argmin.py:147", "max_abs_err": deq_err,
         "ms": dq_ms, "plain_ms": dq_plain, "bound_ms": max(dq_bytes_ms, dq_ops_ms),
         "bound_by": "bytes" if dq_bytes_ms > dq_ops_ms else "operations",
         "library_ms": dq_lib, "rowwarp_ms": dq_old_ms,
         "l2_gather_floor_ms": dq_floor_ms},
        *k4_summaries,
        stage_entry("fused_stage", "nsc_tpu_torch/csrc/fused_stage.cu",
                    "nsc_tpu/ops/pallas/residual_stack.py:513"),
        stage_entry("residual_stack_cl", "nsc_tpu_torch/csrc/residual_stack_cl.cu",
                    "nsc_tpu/ops/pallas/residual_stack.py:121"),
    ]}
    for entry in summary["kernels"]:
        entry["launches_by_path"] = {path: n[entry["name"]] for path, n in by_path.items()}
        by_config = {name: {k: row["kernels"][entry["name"]][k] for k in ("ms", "bound_ms")}
                     for name, row in config_rows.items()
                     if entry["name"] in row.get("kernels", {})}
        if by_config:
            entry["configs"] = by_config
        entry["launches"] = sum(entry["launches_by_path"].values())
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "rtf": rtf, "flagship_rtf": serving_rtf, "float32_rtf_by_conv_backend": stacked_rtf,
          "int8_product": int8_summary})
    emit(summary)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
