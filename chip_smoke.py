#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its own lines:

1. device   nvidia-smi's name and power limit, torch's device name; TF32
            off for convolutions and matrix products.
2. build    nvcc builds the kernels in src/repro_torch/csrc/ (sm_90a).
3. kernels  each kernel's wrapper on CUDA tensors against its plain
            PyTorch version on the same inputs: K1 exit_gate and K2
            calib_nll within the tolerances below, K3 encode / K4 decode
            bit-exact, at the path's shapes and at the edges of each
            kernel layout. Times are device times from CUDA events
            around a replayed CUDA graph of back-to-back calls (no host
            overhead), beside a 1-element add_ as the launch floor. They
            are L2-warm (the same buffers every call) except K1 at
            (256,151936) and K3/K4 at every payload of 1 MB or more (the
            served batches' and the LMs'), which are L2-cold: inputs
            rotate over sets and every call writes fresh outputs, so over
            100 MB pass between two uses of a buffer. K3/K4 print their
            L2-warm time beside it. K2 at (1024,151936) reuses its
            buffers, but its 311 MB (bf16) and 622 MB (f32) inputs are far
            above the 50 MB L2.
            The codec also runs bit-exact at the (n, 10) logit shapes
            of rescore_plan's codec axis, (3000, 10) and (7000, 10), and
            of the fleet, (1024, 10) and (4096, 10); K1 at the runtime's
            and the fleet's (1, 10), (1024, 10) and (2048, 10). The LM's
            shapes: K1 at (8, 151936) bf16 (L2-cold), K2 at (128, 151936)
            bf16, K3/K4 at (4, 2 097 152) int8 and int4 (L2-cold and
            warm); the trained LM's: K1 at mamba2-130m's serve step (2,
            50280) bf16, K2 at its exit logits (2048, 50280) bf16, K3/K4
            at granite-moe's refused rows (4, 786 432) int8 and int4.
            K3/K4 at the runtime's one-request payloads, (1, 16, 16, 64)
            and (1, 8, 8, 96) at levels 1 and 2, L2-warm beside the launch
            floor; K3 also on division ties in each of its five layouts
            and on base pointers off 16 bytes, bit-exact. K5 (qk-norm and
            RoPE, `qk_rope_checks`) against its plain chain at the
            benchmark's Qwen3-8B shapes (64 x 64 and 8 x 512 tokens at the
            edge, 32 x 64 and 4 x 512 at the cloud, 32 + 8 heads of 128), a
            decode step, one rank's heads under a model axis of 2,
            Qwen2-72B's RoPE alone and granite's head_dim 64, in bf16 and
            float32: every element within one bf16 ulp, the share that
            differs printed; timed L2-cold beside its bound and the plain
            chain in bf16.
4. train    B-AlexNet at full width trained with the BranchyNet joint
            loss on cifar_like(seed=0) (45 000 / 3 000 / 7 000), the twin
            of benchmarks/paper_common.train_and_collect: 6 epochs at
            batch 256, AdamW lr 2e-3, warmup 200, no weight decay. Prints
            the loss per epoch, ms per train step and each exit's val /
            test accuracy (argmax from K1), and a profile of 5 more steps
            (kernel time and launches per step, the top kernels).
5. serving  the offload path with the TRAINED weights: make_plan, a K2
            temperature fit, select_partition, the plan's JSON round
            trip, and convnet_engine(...).infer over 8 batches of 512 at
            codec levels 0/1/2 on branch 1 and level 2 on branch 2.
            edge_forward on the card is held against the same port on
            the CPU, on the trained and on the seeded initial weights,
            to an atol derived from each output's scale.
6. paper    the paper's findings on the trained logits: T per exit by the
            plain fit and by the K2 Newton fit, ECE of branch 1 before and
            after, conventional against calibrated gating at p_tar 0.75,
            0.85, 0.9, and the missed-deadline curves of simulate_batches
            at one and two branches, with the fixed link and a Markov one.
7. bank     the distortion bank: val / test distorted over
            default_contexts, fit_bank with input_features, the "torch"
            gate backend against "numpy" (bank blocks, also with vector-
            scaled experts, plan blocks, GateTable,
            window_gate_cells) and rescore_plan over codec levels 0/1/2.
8. runtime  the event-driven serving runtime (`repro_torch.serving`) on
            the card, each run held against the same run of the port on
            the CPU in this process: the congested-Markov scenario of
            BENCH_serving.json (2048 synthetic cascade logits, 2000
            requests at 80 Hz) static, with the controller and static at
            codec level 2, obs off and with full_observability (whose
            trace, audit, metrics and sketch must pass obs.check); the
            distortion-drift scenario of BENCH_distortion.json (the
            uncalibrated, global and PlanBank plans, the controller on
            clean and on context-aware validation, the global plan at
            level 2); then EngineCore on the trained full-width
            B-AlexNet over 512 test images (branch 1 at levels 0 and 2,
            branch 2 at level 2) against a LogitsCore of the same
            engine's batched logits, with host µs per request. The K1,
            K3 and K4 launches of every step are worked out from the
            code beforehand and asserted.
9. fleet    the fleet simulator and the orchestration plane
            (`repro_torch.fleet`, `repro_torch.orchestration`): the
            max-plus FIFO solvers on the card against the oracles (the
            eight edge cases exactly, a 1 048 576-request chain against
            host fifo_done at rel 1e-12, k = 4 servers against
            kserver_oracle), with device us per call; BENCH_fleet.json's
            64-cell reference fleet (102 400 requests, 4 cloud servers) in
            its three arms (uncalibrated, expert bank static, bank with the
            fleet controller) and two codec arms (the compression-aware
            controller over levels 0/1/2, the global plan at level 2), each
            on the card and again on the CPU port with the "numpy" backend,
            on one set of plans fit on the card; then the quick
            adversarial matrix (run_scenarios) on the card against the CPU,
            record by record. The K1, K3 and K4 launches of every run are
            worked out from the code and asserted.
10. compiled the compiled fleet pipeline (`repro_torch.fleet.compiled`,
            backend "compiled") on the card: the 64-cell fleet with phase
            9's plans in three arms (expert bank static, uncalibrated, the
            global plan at codec level 2), each held to the host simulator
            on the same table (columns equal, latencies to rel 1e-9) and
            to BENCH_fleet.json (or phase 9's run, where the bench holds
            no summary); churn shed, a whole-fleet outage, the QoS monitor
            and full observability at 6 cells x 200 requests through
            run_fleet against the host run; a controller and a rollout
            rejected; the scale arm, 256 cells x 1024 = 262 144 requests
            (cut from 256 x 4096 since phase 16, for the script's time),
            against the host simulator with the "numpy" backend.
            Host s of the pre-pass, program and recovery, device ms per
            stage (CUDA events), the device's idle share over one profiled
            run, and the launches of every run asserted.
11. lm      the language-model serving path (`repro_torch.launch.serve`,
            `offload.engine.lm_engine`) on Qwen3-8B at full width and
            depth (36 layers, d 4096, vocab 151 936, exits after layers 8
            and 17; 9.44 B parameters) from a seeded bf16 init: the
            scalar count against param_count(), bytes allocated and peak;
            an uncalibrated and a calibrated plan fit with make_plan on
            both exits' last-position logits of 128 x 256 lm_sequences
            windows (TokenIterator), the K2 fit held to the plain fit
            (same NLL on the token labels, which a seeded model knows
            nothing of; rel 1e-3 in T on labels drawn at a planted T* =
            1.5); per plan, make_prefill_step on 3 batches of 8 x 512 and
            32 make_serve_step tokens from init_cache, 2 K1 launches a
            step asserted, every exit's conf/pred held to the plain gate
            on the same logits and the plan path to the temperatures=
            path; the attention calls' share of a prefill step and of a
            decode step (CUDA events) and the device's busy share of a
            decode step (torch.profiler); lm_engine at codec levels 0/1/2
            over 3 batches of 8 x 512 (K1/K3/K4 launches and
            payload_bytes asserted; at level 0 with every row refused,
            the cloud's logits equal forward_prefill's bit for bit); then
            float32 at full width:
            decode step by step against forward_train at 4 layers (rtol /
            atol 2e-4), and the card against the CPU port at 2 layers
            (derived atol). ms per prefill, per decoded token and per
            lm_engine batch (edge, cloud). K5's launches are worked out
            and asserted at every step (one an attention layer: 36 a
            whole-model step, 9 + 27 an engine batch with refused rows);
            then the edge and cloud partitions at 8 x 512 and 64 x 64
            tokens under torch.no_grad() inside
            torch.cuda.set_sync_debug_mode("error"): no call in either
            may synchronise (`qk_rope_sync_check`).
12. train_lm LM training and the rest of the model zoo from seeded bf16
            inits: (a) mamba2-130m at full width and depth trained as
            examples/train_lm.py --preset 100m trains it (200 AdamW steps
            at 16 x 128 of lm_sequences(800 000, order=1, branch=4), lr
            1e-3, warmup 20, remat off; every loss finite, each below its
            step-0 value and log V at the end), make_eval_step on a
            held-out batch, T per exit by the plain fit and by K2 (held
            as phase 11 holds them), 32 tokens x 2 sequences served
            through make_serve_step(temperatures=...) with 2 K1 launches a
            step asserted, and a float32 train step at 2 layers on the
            card against the CPU (loss, every gradient leaf; derived
            atol); (b) olmo-1b at full width and depth through
            launch.train.main (5 steps at 8 x 512, remat), ms per step,
            peak GB with remat and for one step without, the checkpoint
            reloaded bit for bit; (c) granite-moe-3b-a800m at full width
            and depth: prefill 8 x 512 and 32 decode steps from its caches
            (MoE dropped share and aux loss), one train step at 4 x 512
            with remat, in place, and lm_engine at codec levels 0/1/2
            (K1/K3/K4 launches asserted); (d) jamba-v0.1-52b at full width
            cut to one 8-layer period (attention at layer 4, MoE on odd
            layers, exit after layer 3): prefill 2 x 512, 8 decode steps,
            and decode against forward_train in float32 at 2 layers;
            (e) whisper-base: 3 launch.train steps at 8 x 128 on zero
            frames, prefill, 8 decode steps with the cross caches, and
            decode against forward_train in float32.
13. dryrun  the dry run (`repro_torch.launch.dryrun`) on the card: every
            LM arch at prefill_32k and qwen3-8b at all four input shapes,
            traced on fake CUDA tensors in six processes at once, each
            asserting that its trace launched no kernel and left
            torch.cuda.memory_allocated() unchanged (GFLOPs, GB by part,
            fits one card, trace s); then the steps phases 11-12 run --
            Qwen3-8B prefill 8 x 512, olmo-1b remat train 8 x 512,
            mamba2-130m train 16 x 128 -- traced and run for real: the
            dry run's FLOPs beside the measured ms and the achieved
            TFLOP/s against the bf16 dense peak, its peak bytes beside
            max_memory_allocated; then latency.h100 from the trained
            B-AlexNet engine's stats (both branches served warm with every
            sample offloaded) beside paper_2020.
14. ranks   several ranks (`python -m torch.distributed.run --standalone
            --nproc-per-node W` on this script with ``--ranks DIR``, one
            process per rank, each a full replica): W is the card count
            where it is 2 or more (NCCL, a card a rank), else 2 ranks
            sharing the one card (gloo). The same runs first on one rank
            in this process, which then frees its cache. (a) olmo-1b at
            full width and depth through launch.train, 3 steps at a global
            8 x 512 with remat: per-step loss and grad_norm held to the
            one-rank run within the derived bf16 bound (W + 2) 2^-8, and a
            float32 2-layer twin at rtol / atol 2e-4; (b) B-AlexNet at full
            width, 3 steps at a global 256, float32, 2e-4; (c) granite-moe's
            widths reduced to 4 layers (capacity factor 1.0, so tokens
            drop), float32, one step at 4 x 512: 2e-4 and the dropped
            (token, slot) counts per layer equal; (d) the compiled fleet
            sharded over cells: phase 10's 64-cell global-plan arm at codec
            level 2 and its 256 x 1024 arm, from the plans (PlanBank JSON)
            and results phase 10 wrote to build/chip_smoke/ranks/, equal to
            them at rel 1e-9 on every rank. Every rank's params equal;
            each rank's peak GB; each rank's K1/K3/K4 launches worked out
            from the code and asserted, and summed under "ranks".
15. tp      tensor parallelism: LM serving with the parameters split over
            a model axis (W processes of this script with ``--tp DIR``,
            each with the rank environment `python -m
            torch.distributed.run --standalone --nproc-per-node W` sets:
            `launch_ranks`, which spares the launcher's start; a (data
            1, model W) mesh; W as in phase 14: the card count where it is
            2 or more, NCCL, else 2 ranks sharing the one card over gloo),
            each rank's params from the sharded init (bit for bit its
            slices of the one-device stream). The same runs first on one
            rank in this process. (a) Qwen2-72B's widths reduced to 4
            layers (exits moved inside the cut), bf16: prefill 8 x 512
            (three times, then once with every all-reduce timed between
            two syncs: their share of the step), 8 decode steps from the
            prefill's caches, the last against a prefill over the same
            tokens, lm_engine at codec levels 0 and 2; logits held to one
            rank within the derived bf16 bound (2L + 2) 2u of max|z|,
            predictions and gate decisions equal wherever one rank's
            margins clear it, payload_bytes equal; (b) a float32 twin at 2
            layers (4 x 128, 4 decode steps) at rtol / atol 2e-4 with
            predictions and decisions equal; (c) granite-moe's widths
            reduced to 4 layers, float32, capacity factor 1.0 (tokens
            drop), its 40 experts split over the ranks: prefill 4 x 512 at
            2e-4 with the dropped counts per layer equal. ms a step and a
            token, peak GB per rank, the all-reduces' share; each rank's
            K1/K3/K4 launches worked out from the code and asserted.
            `tools/tp_phase.py` runs this phase alone, and on four cards
            also Qwen2-72B uncut (80 layers, over NCCL).
16. tp_train tensor-parallel training on the same kind of mesh (``--tp-train
            DIR``), then the trained model calibrated and served on it. The
            same training first on one rank in this process. (a) Qwen3-8B's
            widths reduced to 4 layers (exits moved inside the cut), bf16:
            3 remat steps at 8 x 512 with launch.train's AdamW, losses and
            grad_norm per step held to one rank within the derived bound
            (2L + 2) 2u, then the step's forward and backward once more with
            every all-reduce timed (their share, by pass); its reduces alone
            at its shapes: model_grad's backward the float32 sum of the
            ranks' gradients rounded once, _WideMM's forward within its
            float32 bound and its gradients one device's bf16 product bit
            for bit; (b) a float32 twin at 2 layers (4 x 128, 3 steps):
            metrics and every gradient leaf at every step at rtol / atol
            2e-4, the params after the steps at rtol / atol 2e-4 on every
            element whose gradient stayed within rel 0.1 of one rank's (the
            rest, where rounding sets Adam's update, at most 1e-3 of the
            model, counted by leaf), each rank against its slices of the
            one-rank run's, which this process keeps in memory and serves
            them over a local socket, the ranks' checkpoint, one device's
            file, reloaded bit for bit on every rank; every replicated leaf
            bit-equal over the ranks; (c)
            granite-moe reduced to 4 layers, float32, capacity factor 1.0,
            its experts split over the ranks: one step held as (b), dropped
            counts per layer equal; (d) the trained model (a): the eval
            step's whole-vocab exit logits of a validation batch, each
            exit's K2 fit held to the plain fit, on labels planted at T* =
            1.5 too, OffloadPlans of the K2 temperatures (the token
            labels' and, for exit 0, the planted labels'), lm_engine over
            the mesh at levels 0 and 2 under each, its gate confidences
            held to rank 0 serving the same weights gathered whole on one
            rank within the bf16 bound, its decisions away from p_tar +-
            1e-6. ms a step and peak GB per rank; each rank's K1-K4
            launches worked out and asserted. `tools/tp_phase.py` runs it
            after phase 15, and on four cards also trains Qwen3-8B uncut
            (36 layers, over NCCL).
17. tp_ssm  the mamba and hybrid families on the same kind of mesh
            (``--tp-ssm DIR``), each mamba layer on its block of SSD heads
            with B and C whole (`sharding.layout_specs`); the same runs
            first on one rank in this process. (a) mamba2-130m uncut, bf16:
            prefill 8 x 512, 16 tokens decoded from its caches, lm_engine
            at codec levels 0 and 2, held within the derived (2L + 2) 2u
            of max|z|, then 3 remat steps at 8 x 512 held as phase 16 holds
            its bf16 run; (b) its float32 twin, uncut: prefill 4 x 256 and
            4 tokens at rtol / atol 2e-4, 3 steps at 4 x 256 held as phase
            16 holds its twin (every gradient leaf at every step, the
            params, every element held whole bit-equal over the ranks, the
            checkpoint), then the trained twin calibrated (K2 against the
            plain fit, on labels planted at T* = 1.5 too) and served over
            the mesh at levels 0 and 2; (c) jamba-v0.1-52b's widths
            reduced to one 8-layer period, bf16: prefill 8 x 512, 8 tokens,
            lm_engine at levels 0 and 2, held as (a) on the rows whose
            tokens every rank routed as one rank did (the others finite),
            each MoE layer's dropped count within its rerouted tokens of
            one rank's; (d) jamba reduced to 2 layers (mamba + MLP, mamba +
            MoE): one bf16 remat step at 4 x 512 held as (a). ms a step and
            a token, peak GB per rank, the all-reduces' share by pass; each
            rank's K1-K4 launches worked out and asserted.
            `tools/tp_phase.py --ssm` runs it alone, and on four cards
            also serves jamba-v0.1-52b uncut (32 layers, over NCCL) beside
            the dry run's peak of its prefill as rank 0 of the mesh.
18. tp_enc_dec the encoder-decoder on the same kind of mesh (``--tp-enc-dec
            DIR``): whisper-base's encoder, decoder and cross-attention
            heads and d_ff split over the ranks (its vocabulary of 51 865
            too where W divides it: neither 2 nor 4 does); the same runs
            first on one rank in this process. (a) uncut, bf16, frames (4,
            1500, 512): prefill 4 x 448, 8 tokens decoded from its caches,
            held within the derived (2 Le + 3 Ld + 3) 2u of max|z|, the
            exits' predictions and K1 decisions where one rank's margins
            clear it; 3 remat steps at 4 x 128 held as phase 16 holds its
            bf16 run; (b) its float32 twin, uncut: prefill 2 x 64 and 4
            tokens at rtol / atol 2e-4, 3 steps at 2 x 64 held as phase 16
            holds its twin (every gradient leaf at every step, the params,
            every replicated element bit-equal over the ranks, the
            checkpoint); (c) the twin calibrated over the mesh: each exit's
            K2 fit on the eval step's gathered exit logits against one
            rank's (T within rel 2e-4, or the NLL where it is flat), and a
            plan served through make_prefill_step(plan=), its confidences
            at 2e-4 and its predictions and decisions one rank's. ms a
            step and a token, peak GB per rank, the all-reduces' share by
            pass; each rank's K1 and K2 launches worked out and asserted.
            `tools/tp_phase.py --enc-dec` runs it alone.
19. result  the script's seconds, one JSON line with every kernel's
            numbers, the nvidia-smi line, and last {"ok": true, "device":
            {...}}.

Phases 4-18 are the main path: each sets the launch counts to 0 just
before it and reads them just after, and fails if a kernel of its path
did not run (train: K1; serving: K1-K4; paper: K1, K2; bank: K1, K3,
K4; runtime: K1, K3, K4; fleet and compiled: K1, K3, K4; lm and
train_lm: K1-K5; dryrun: K1; ranks and tp: K1, K3, K4, tp_train and
tp_ssm: K1-K4, tp_enc_dec: K1, K2, counted in each rank from 0 over its
runs, while this process launches none).
Every line that prints a time names the card and its power limit.

Any failure raises, so the process exits non-zero and prints no result;
without a GPU it exits 2 before doing anything. Imports neither jax nor
the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet): memory rate and float32
# rate outside the tensor cores -- the roofline every bound_ms is against
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# and the bf16 dense tensor-core rate, which phase 13 holds a step's
# achieved FLOP/s against
BF16_FLOP_PER_S = 989e12
# an L2-cold timing keeps more than this much traffic between two uses of
# a buffer: twice the H100's 50 MB L2
COLD_BYTES = 100e6

# tolerances (K1 as tests/test_kernels.py; K2 as the calib_stats tests)
K1_CONF = dict(rtol=2e-5, atol=1e-6)
K1_ENT = dict(rtol=2e-5, atol=2e-5)
K2_NLL = dict(rtol=1e-5, atol=1e-6)
K2_D1 = dict(rtol=5e-3, atol=1e-5)
K2_D2 = dict(rtol=5e-3, atol=1e-3)

# benchmarks/paper_figures.py's grid of per-sample deadlines (s)
T_TAR_GRID = [0.5e-3, 1e-3, 2e-3, 3e-3, 5e-3, 7.5e-3, 10e-3, 15e-3, 25e-3, 50e-3]
PAPER_P_TARS = (0.75, 0.85, 0.9)
# the kernels each main-path phase must launch ("serving" and "lm" launch
# K2 as a side check held to make_plan's plain fit, which makes the plans)
PHASE_KERNELS = {"train": ("exit_gate",),
                 "serving": ("exit_gate", "calib_nll", "encode", "decode"),
                 "paper": ("exit_gate", "calib_nll"),
                 "bank": ("exit_gate", "encode", "decode"),
                 "runtime": ("exit_gate", "encode", "decode"),
                 "fleet": ("exit_gate", "encode", "decode"),
                 "compiled": ("exit_gate", "encode", "decode"),
                 "lm": ("exit_gate", "calib_nll", "encode", "decode", "qk_norm_rope"),
                 "train_lm": ("exit_gate", "calib_nll", "encode", "decode", "qk_norm_rope"),
                 "dryrun": ("exit_gate",),
                 "ranks": ("exit_gate", "encode", "decode"),
                 "tp": ("exit_gate", "encode", "decode"),
                 "tp_train": ("exit_gate", "calib_nll", "encode", "decode"),
                 "tp_ssm": ("exit_gate", "calib_nll", "encode", "decode"),
                 "tp_enc_dec": ("exit_gate", "calib_nll")}
# the log grid K2's LM temperature fit starts its Newton steps from
K2_GRID = (0.25, 0.5, 1.0, 2.0, 4.0)
# K1's boundary: the kernel's conf = 1/S and the plain max(exp(logp)) are
# about 1e-7 apart, so decisions are compared only away from p_tar +- this
BOUNDARY = 1e-6

KERNEL_ROWS = {
    "exit_gate": ("src/repro_torch/csrc/exit_gate.cu", "src/repro/kernels/exit_gate.py:88"),
    "calib_nll": ("src/repro_torch/csrc/calib_nll.cu", "src/repro/kernels/calib_nll.py:81"),
    "encode": ("src/repro_torch/csrc/codec.cu", "src/repro/kernels/compress.py:122"),
    "decode": ("src/repro_torch/csrc/codec.cu", "src/repro/kernels/compress.py:158"),
    "qk_norm_rope": ("src/repro_torch/csrc/qk_rope.cu",
                     "none: the reference's qk-norm and RoPE are XLA (repro/models/layers.py)"),
}


def bound_ms(nbytes: float, flops: float):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the float32 rate. Returns (ms, "bytes"|"operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def device_ms(fn, calls=20, reps=5, keep=False):
    """Median device ms of one call: `calls` calls, fn(0) .. fn(calls-1),
    captured in a CUDA graph and replayed `reps` times between CUDA
    events. With keep=True every call's outputs stay allocated, so no
    two calls share an output buffer."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    held = []
    with torch.cuda.graph(graph):
        for i in range(calls):
            if keep:
                held.append(fn(i))
            else:
                fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph, held
    torch.cuda.synchronize()
    return float(np.median(times))


def calls_for(nbytes):
    return 20 if nbytes < 64e6 else 3


def cold_plan(nbytes):
    """(input sets, calls) for an L2-cold timing: inputs rotate over
    enough sets that a call's inputs were last touched more than
    COLD_BYTES of traffic ago, and each call writes fresh outputs."""
    sets = max(2, -(-int(COLD_BYTES) // int(nbytes)) + 1)
    calls = -(-max(calls_for(nbytes), sets) // sets) * sets
    return sets, calls


def k5_launches(cfg, lo, hi):
    """K5's launches in one forward call of layers lo .. hi-1 on the card
    without autograd: one a RoPE attention layer, where K5 takes the
    head_dim (`qk_rope.HEAD_DIMS`; the config's bf16 or the cloud's
    float32 it always reads)."""
    from repro_torch.kernels import qk_rope

    if not (cfg.use_rope and cfg.head_dim in qk_rope.HEAD_DIMS):
        return 0
    return sum(1 for mixer, _ in cfg.layer_plan()[lo:hi] if mixer == "attn")


def ordered_bits(t):
    """bf16 or float32 values as integers in the order of the values (-0 and
    +0 both 0), so that a difference of two is their distance in ulps."""
    import torch

    if t.dtype == torch.bfloat16:
        i = t.view(torch.int16).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    i = t.view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp of `want` (float32 values: the
    bf16 spacing at |want|, 2^-7 of its binade; bf16: the ulp distance)."""
    import torch

    if want.dtype == torch.bfloat16:
        return (ordered_bits(got) - ordered_bits(want)).abs()
    w = want.double().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return (got.double() - want.double()).abs() / ulp


# K5's checks: (b, s, q heads, kv heads, head_dim, qk-norm, theta, what). The
# benchmark's Qwen3-8B cells' edge and cloud calls (cell 4: 64 x 64 tokens,
# the cloud at m = 32 of 64 rows; cell 2: 8 x 512, m = 4 of 8), a decode
# step, one rank's heads under a model axis of 2, Qwen2-72B (RoPE alone) and
# granite-moe (head_dim 64)
K5_CASES = (
    (64, 64, 32, 8, 128, True, 1e6, "cell 4 edge"),
    (32, 64, 32, 8, 128, True, 1e6, "cell 4 cloud"),
    (8, 512, 32, 8, 128, True, 1e6, "cell 2 edge"),
    (4, 512, 32, 8, 128, True, 1e6, "cell 2 cloud"),
    (8, 1, 32, 8, 128, True, 1e6, "decode at position 511"),
    (8, 512, 16, 4, 128, True, 1e6, "model axis of 2"),
    (8, 512, 64, 8, 128, False, 1e6, "qwen2-72b, RoPE alone"),
    (8, 512, 24, 8, 64, False, 1e4, "granite, head_dim 64"),
)


def qk_rope_checks(dev, record, say=print):
    """Phase 3's K5 part: the kernel against its plain chain on the card at
    `K5_CASES` in bf16 and float32, each output element within one bf16
    ulp (the sum of squares runs in another order; the share off by one is
    printed), then timed L2-cold beside its bound and the plain chain's
    time where it is bf16 (`record(kernel, case, err, ms, plain_ms, nbytes,
    flops, path=...)`). Positions: the partitions' expanded int32 arange,
    int64 contiguous at the model-axis case, a decode step's (b, 1)."""
    import torch

    from repro_torch.kernels import qk_rope

    gen = torch.Generator(device=dev).manual_seed(31)
    share = {}
    for b, s, qh, kvh, hd, norm, theta, what in K5_CASES:
        if s == 1:
            pos = torch.full((b, 1), 511, dtype=torch.int32, device=dev)
        elif what == "model axis of 2":
            pos = torch.arange(s, dtype=torch.int64, device=dev).repeat(b, 1)
        else:
            pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        scales = ((1 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                   1 + 0.1 * torch.randn(hd, generator=gen, device=dev)) if norm
                  else (None, None))
        for dtype in (torch.bfloat16, torch.float32):
            case = f"{what} ({b} x {s}, {qh} + {kvh} heads of {hd}, {str(dtype)[6:]})"
            q = (2 * torch.randn(b, s, qh, hd, generator=gen, device=dev)).to(dtype)
            k = (2 * torch.randn(b, s, kvh, hd, generator=gen, device=dev)).to(dtype)
            got = qk_rope.qk_norm_rope(q, k, *scales, pos, theta)
            want = qk_rope.qk_norm_rope_ref(q, k, *scales, pos, theta, 1e-6)
            torch.cuda.synchronize()
            ulps = torch.cat([bf16_ulps(g, w).flatten() for g, w in zip(got, want)])
            off = torch.cat([(g != w).flatten() for g, w in zip(got, want)])
            assert float(ulps.max()) <= 1.0, f"K5 more than one bf16 ulp off: {case}"
            share[case] = float(off.double().mean())
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size() + (4 * hd if norm else 0)
            say(f"K5 {case}: max {float(ulps.max()):.3g} bf16 ulp, {share[case]:.3%} of the "
                f"elements differ from the plain chain (max |diff| {err:.3g})")
            if dtype != torch.bfloat16:
                continue
            sets, calls = cold_plan(nbytes)
            qs = [q] + [q.clone() for _ in range(sets - 1)]
            ks = [k] + [k.clone() for _ in range(sets - 1)]
            ms = device_ms(lambda i: qk_rope.qk_norm_rope(qs[i % sets], ks[i % sets], *scales,
                                                          pos, theta), calls, keep=True)
            pms = device_ms(lambda i: qk_rope.qk_norm_rope_ref(qs[i % sets], ks[i % sets],
                                                               *scales, pos, theta, 1e-6),
                            calls, keep=True)
            record("qk_norm_rope", case, err, ms, pms, nbytes,
                   15.0 * (q.numel() + k.numel()), path=(what == "cell 4 edge"))
            del qs, ks
    return share


def qk_rope_sync_check(dev, cfg, params, batches, say=print):
    """Qwen3's edge partition (layers up to exit 0) and cloud partition (the
    rest, on the first half of the rows) under `torch.no_grad()` inside
    `torch.cuda.set_sync_debug_mode("error")`, as the offload engine calls
    them: no call in either may synchronise with the card. K5's launches in
    each worked out (`k5_launches`) and asserted."""
    import torch

    from repro_torch.kernels import qk_rope
    from repro_torch.models import transformer

    k5 = qk_rope.KERNEL
    cut = cfg.exit_layers[0] + 1
    want = (k5_launches(cfg, 0, cut), k5_launches(cfg, cut, cfg.num_layers))
    for tokens in batches:
        torch.cuda.synchronize()
        before = k5.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                edge = transformer.edge_forward(params, cfg, {"tokens": tokens}, exit_index=0)
                mid = k5.launches
                cloud = transformer.cloud_forward(params, cfg,
                                                  edge["hidden"][:tokens.shape[0] // 2],
                                                  exit_index=0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        got = (mid - before, k5.launches - mid)
        assert got == want, f"K5 launches (edge, cloud) {got}, worked out {want}"
        assert torch.isfinite(cloud["logits"].float()).all()
        say(f"{tuple(tokens.shape)} tokens: edge_forward and cloud_forward on "
            f"{tokens.shape[0] // 2} rows under no_grad ran with no synchronising call "
            f"(set_sync_debug_mode 'error'); K5 launches (edge, cloud) {got}")
        del edge, cloud


def train_phase(dev, data, epochs, batch, seed=0, say=print):
    """Train B-AlexNet with the BranchyNet joint loss through the port's
    entry points (the twin of benchmarks/paper_common.train_and_collect)
    and collect every exit's val / test logits. Returns (params, logits,
    stats)."""
    import torch

    from repro_torch.core.exits import gate_statistics
    from repro_torch.models import convnet
    from repro_torch.training import optim
    from repro_torch.training.loop import make_eval_step, make_train_step

    params = convnet.init_params(torch.Generator(device=dev).manual_seed(seed), device=dev)
    ntr = len(data.train_y)
    n_steps = epochs * (ntr // batch)
    # no weight decay: the conventional recipe whose overconfidence the
    # paper calibrates away
    opt_cfg = optim.AdamWConfig(lr=2e-3, weight_decay=0.0, total_steps=n_steps,
                                warmup_steps=200)
    step_fn = make_train_step(convnet.B_ALEXNET, opt_cfg, device=dev)
    state = optim.init(params)
    train_x = torch.as_tensor(data.train_x, device=dev)
    train_y = torch.as_tensor(data.train_y, device=dev)
    rng = np.random.default_rng(seed)
    stats = {"first_loss": None, "epoch_loss": [], "step_ms": [], "finite": True}
    for ep in range(epochs):
        order = torch.as_tensor(rng.permutation(ntr), device=dev)
        losses, times = [], []
        for s in range(0, ntr - batch + 1, batch):
            t0 = time.perf_counter()
            idx = order[s:s + batch]
            params, state, m = step_fn(params, state,
                                       {"images": train_x[idx], "labels": train_y[idx]})
            _sync(dev)
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"])
        losses = torch.stack(losses).cpu().numpy()
        stats["finite"] &= bool(np.isfinite(losses).all())
        if stats["first_loss"] is None:
            stats["first_loss"] = float(losses[0])
        stats["epoch_loss"].append(float(losses.mean()))
        stats["step_ms"].append(1e3 * float(np.median(times)))
        say(f"epoch {ep}: loss mean {losses.mean():.4f} last {losses[-1]:.4f}; "
            f"{stats['step_ms'][-1]:.3f} ms per train step (median of {len(times)})", timed=True)

    eval_fn = make_eval_step(convnet.B_ALEXNET, device=dev)

    def collect(x):
        outs = [eval_fn(params, {"images": x[s:s + 512]}) for s in range(0, len(x), 512)]
        return [torch.cat([o["exit_logits"][i] for o in outs]) for i in (0, 1)] + [
            torch.cat([o["logits"] for o in outs])]

    z = {"val": collect(data.val_x), "test": collect(data.test_x),
         "val_y": torch.as_tensor(data.val_y, device=dev),
         "test_y": torch.as_tensor(data.test_y, device=dev)}
    stats["accuracy"] = {
        f"{split}_{head}": float((gate_statistics(lg)[1] == z[f"{split}_y"]).float().mean())
        for split in ("val", "test") for head, lg in zip(("b1", "b2", "main"), z[split])
    }
    say("accuracy " + " ".join(f"{k} {v:.4f}" for k, v in stats["accuracy"].items()))

    if dev.type == "cuda":
        # where a train step's time goes: 5 more steps under the profiler,
        # whose results are dropped (the step is functional, so the trained
        # params stay as they are). Kernel time per step against the
        # unprofiled median step time gives the device's busy share.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        b = {"images": train_x[:batch], "labels": train_y[:batch]}
        p2, s2 = params, state
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                p2, s2, _ = step_fn(p2, s2, b)
            _sync(dev)
        kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in kern) / 5e3
        stats["kernel_ms"] = busy_ms
        say(f"profiled step: {busy_ms:.3f} ms of kernels in {sum(e.count for e in kern) / 5:.0f} "
            f"launches per step, {busy_ms / stats['step_ms'][-1]:.1%} of the last epoch's "
            f"median step; top: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / 5e3:.3f} ms x{e.count // 5}"
                for e in kern[:6]), timed=True)
    return params, z, stats


def paper_phase(dev, z, say=print):
    """The paper's findings on trained logits; returns every printed value
    that must lie in [0, 1] and the two temperature fits."""
    from repro_torch.core import metrics
    from repro_torch.core.calibration import TemperatureScaling
    from repro_torch.core.exits import gate_statistics
    from repro_torch.core.policy import OffloadPlan, make_plan
    from repro_torch.kernels import ops
    from repro_torch.offload import latency
    from repro_torch.offload.simulator import missed_deadline_curve, simulate_batches
    from repro_torch.serving.network import MarkovNetwork

    (vb1, vb2, vm), (tb1, tb2, tm) = z["val"], z["test"]
    vy, ty = z["val_y"], z["test_y"]
    out = {"values": []}
    t_plain = make_plan([vb1, vb2, vm], vy, p_tar=0.8).temperatures
    t_k2 = [float(ops.fit_temperature_kernel(v, vy)[0]) for v in (vb1, vb2, vm)]
    out["t_plain"], out["t_k2"] = t_plain, t_k2
    say(f"T (branch 1, branch 2, main): make_plan's plain fit "
        f"{[round(t, 6) for t in t_plain]}; K2 Newton fit {[round(t, 6) for t in t_k2]}")
    t1 = t_plain[0]
    for label, temp in (("before", 1.0), ("after", t1)):
        conf, pred, _ = gate_statistics(tb1, temp)
        e = metrics.ece(conf, pred == ty)
        out["values"].append(e)
        say(f"branch 1 test ECE {label} calibration (T={temp:.4f}): {e:.4f}")
    for p in PAPER_P_TARS:
        parts = []
        for name, temp in (("conventional", 1.0), ("calibrated", t1)):
            st = metrics.device_statistics(tb1, ty, p, temp)
            row = [float(st["on_device_prob"]), float(st["device_accuracy"]),
                   metrics.overall_accuracy([tb1], tm, ty, p, [temp]),
                   metrics.inference_outage_probability(tb1, ty, p, temp)]
            out["values"] += row
            parts.append(f"{name}: on-device {row[0]:.4f} device-acc {row[1]:.4f} "
                         f"overall-acc {row[2]:.4f} outage {row[3]:.4f}")
        say(f"p_tar {p}: " + "; ".join(parts))
    prof = latency.paper_2020()
    p_md = 0.85
    n_batches = -(-len(ty) // 512)
    for branches in ((1,), (1, 2)):
        logits = [tb1, tb2][:len(branches)]
        plan = OffloadPlan(p_tar=p_md, calibrators=[TemperatureScaling.from_temperature(t)
                                                    for t in t_plain[:len(branches)]])
        runs = {
            "conventional": simulate_batches(logits, tm, ty, p_md, [1.0] * len(branches), prof,
                                             branches=branches),
            "calibrated": simulate_batches(logits, tm, ty, profile=prof, branches=branches,
                                           plan=plan),
            "calibrated, Markov link": simulate_batches(
                logits, tm, ty, profile=prof, branches=branches, plan=plan,
                network=MarkovNetwork(seed=0), batch_times_s=[0.5 * k for k in range(n_batches)]),
        }
        for name, outcomes in runs.items():
            curve = missed_deadline_curve(outcomes, T_TAR_GRID, p_md)
            out["values"] += curve + [o.accuracy for o in outcomes] + [
                o.on_device_frac for o in outcomes]
            say(f"missed deadline, branches {branches}, p_tar {p_md}, {name}: "
                f"{[round(c, 4) for c in curve]} over t_tar {T_TAR_GRID} s")
    return out


def bank_phase(dev, params, data, z, say=print):
    """Distortion contexts, the expert bank, the "torch" gate backend held
    against "numpy", and one rescore_plan over codec levels 0/1/2."""
    import torch

    from repro_torch.core.bank import PlanBank, fit_bank
    from repro_torch.core.calibration import get_calibrator
    from repro_torch.core.control import rescore_plan
    from repro_torch.core.gatepath import GateTable, get_gate_backend
    from repro_torch.data.distortion import apply_distortion, default_contexts, input_features
    from repro_torch.kernels import exit_gate
    from repro_torch.models import convnet
    from repro_torch.offload import latency

    def logits_of(x):
        with torch.no_grad():
            outs = [convnet.forward(params, torch.as_tensor(x[s:s + 512], device=dev))
                    for s in range(0, len(x), 512)]
        return ({b: torch.cat([o["exit_logits"][b - 1] for o in outs]) for b in (1, 2)},
                torch.cat([o["logits"] for o in outs]))

    t0 = time.perf_counter()
    val_exits, val_feats, test_exits, test_final, test_feats = {}, {}, {}, {}, {}
    for spec in default_contexts():
        # the val / test seeds of distort_splits(seed=0)
        vx = apply_distortion(data.val_x, spec, seed=1)
        tx = apply_distortion(data.test_x, spec, seed=2)
        val_feats[spec.key], test_feats[spec.key] = input_features(vx), input_features(tx)
        val_exits[spec.key], _ = logits_of(vx)
        test_exits[spec.key], test_final[spec.key] = logits_of(tx)
    _sync(dev)
    say(f"{len(val_exits)} contexts distorted (numpy) and run through the trained net in "
        f"{time.perf_counter() - t0:.2f} s", timed=True)

    vy, ty = z["val_y"], z["test_y"]
    t0 = time.perf_counter()
    bank = fit_bank({c: [e[1], e[2]] for c, e in val_exits.items()}, vy, p_tar=0.8,
                    features_by_context=val_feats, device=dev)
    _sync(dev)
    say(f"fit_bank: {len(bank.contexts)} experts in {time.perf_counter() - t0:.3f} s; T "
        + "; ".join(f"{c} {[round(t, 4) for t in bank.plans[c].temperatures]}"
                    for c in bank.contexts) + f"; fit ECE {bank.metadata['fit_ece']}", timed=True)

    p, boundary = bank.default_plan.p_tar, 0

    def held(got, want, what):
        nonlocal boundary
        (tc, tp), (nc, npred) = got[:2], want[:2]
        np.testing.assert_allclose(tc, nc, **K1_CONF, err_msg=what)
        assert np.array_equal(tp, npred), f"{what}: predictions differ"
        away = np.abs(nc - p) > 1e-6
        assert np.array_equal((tc >= p)[away], (nc >= p)[away]), f"{what}: decisions differ"
        boundary += int((~away).sum())

    for ctx in bank.contexts:
        got = bank.gate_block(test_exits[ctx][1], features=test_feats[ctx], branch=0,
                              backend="torch")
        want = bank.gate_block(test_exits[ctx][1], features=test_feats[ctx], branch=0,
                               backend="numpy")
        assert np.array_equal(got[2], want[2])
        held(got, want, f"bank.gate_block {ctx}")
    for bi in (0, 1):
        held(bank.default_plan.gate_block(test_exits["clean"][bi + 1], branch=bi,
                                          backend="torch"),
             bank.default_plan.gate_block(test_exits["clean"][bi + 1], branch=bi,
                                          backend="numpy"), f"plan.gate_block branch {bi + 1}")
    # calibrators richer than a temperature stay on the card too: vector
    # scaling on the default plan and on one expert, one K1 launch a block
    vbank = PlanBank.from_json(bank.to_json())
    vector_ctx = [vbank.default_context, next(c for c in vbank.contexts
                                              if c != vbank.default_context)]
    for ctx in vector_ctx:
        vbank.plans[ctx].calibrators[0] = get_calibrator("vector").fit(val_exits[ctx][1], vy)
    for ctx in vbank.contexts:
        k1 = exit_gate.KERNEL.launches
        got = vbank.gate_block(test_exits[ctx][1], features=test_feats[ctx], branch=0,
                               backend="torch")
        assert exit_gate.KERNEL.launches == k1 + 1, "a vector bank block is not one K1 launch"
        held(got, vbank.gate_block(test_exits[ctx][1], features=test_feats[ctx], branch=0,
                                   backend="numpy"), f"vector bank.gate_block {ctx}")
    table = GateTable(test_exits, test_final, bank, labels=data.test_y,
                      features_by_context=test_feats, backend="torch")
    host = GateTable(test_exits, test_final, bank, labels=data.test_y,
                     features_by_context=test_feats, backend="numpy")
    np.testing.assert_allclose(table.conf, host.conf, **K1_CONF)
    assert np.array_equal(table.pred, host.pred)
    rng = np.random.default_rng(5)
    n_rows = 4000
    ctx_ids = rng.integers(0, len(table.ctx_keys), n_rows)
    samples = rng.integers(0, table.n_samples, n_rows)
    cells = rng.integers(0, 5, n_rows)
    branch_by_cell, p_by_cell = [1, 2, 1, 2, 1], [0.7, 0.8, 0.85, 0.9, 0.75]
    got = table.gate_window_cells(ctx_ids, samples, cells, branch_by_cell, p_by_cell, 5)
    want = get_gate_backend("numpy").window_gate_cells(
        table.conf, table.pred, ctx_ids, samples, cells,
        [table.branch_idx(b) for b in branch_by_cell], p_by_cell, 5)
    for k in want:
        assert np.array_equal(got[k], want[k]), f"window_gate_cells {k} differs"
    say(f"torch gate backend held against numpy: bank blocks in {len(bank.contexts)} contexts, "
        f"vector-scaled experts {vector_ctx}, plan blocks at branches 1 and 2, the GateTable, window_gate_cells on {n_rows} rows "
        f"(on-device per cell {got['on_count'].tolist()}); {boundary} samples within 1e-6 of "
        f"p_tar left out of the decision check")

    prof = latency.paper_2020()
    (vb1, vb2, vm) = z["val"]
    t0 = time.perf_counter()
    new_plan, cands = rescore_plan(
        bank.plan_for("clean"), [vb1, vb2],
        edge_times_s=[latency.edge_time(prof, b) for b in (1, 2)],
        cloud_times_s=[latency.cloud_time(prof, b) for b in (1, 2)],
        payload_bytes=[latency.payload_bytes_for(b) for b in (1, 2)],
        uplink_bps=prof.uplink_bps, labels=vy, final_logits=vm,
        p_tar_grid=[0.75, 0.8, 0.85, 0.9], compression_levels=(0, 1, 2),
        exit_layer_indices=[0, 1])
    best = cands[0]
    say(f"rescore_plan over {len(cands)} candidates (branch x p_tar x codec level) in "
        f"{time.perf_counter() - t0:.3f} s; winner branch {new_plan.exit_index + 1} p_tar "
        f"{new_plan.p_tar} level {new_plan.compression_level} (fastest row: latency "
        f"{best['expected_latency_s'] * 1e3:.3f} ms, accuracy {best['accuracy']:.4f})", timed=True)


def near_boundary(conf, p_tars) -> int:
    """How many confidences lie within BOUNDARY of any of `p_tars`."""
    c = np.asarray(conf, np.float64).ravel()
    return int(sum((np.abs(c - p) <= BOUNDARY).sum() for p in p_tars))


def same_summary(a, b, what):
    """Telemetry summaries equal: integers exactly, floats exactly or to
    rel 1e-12 (float sums), nan matching nan."""
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and isinstance(y, float):
            ok = (x == y or (x != x and y != y)
                  or abs(x - y) <= 1e-12 * max(abs(x), abs(y)))
        else:
            ok = x == y
        assert ok, f"{what}: {k} {x!r} against {y!r}"


def runtime_phase(dev, params, data, plan, drift, say=print):
    """The event-driven serving runtime on `dev`, every run held against
    the same run on the CPU; the launches of every step asserted. `plan`
    carries the trained exits' temperatures; `drift` is (val, test,
    (uncalibrated, global, bank)) of the distortion scenario."""
    import tempfile

    import torch

    from repro_torch._device import to_numpy
    from repro_torch.core.calibration import TemperatureScaling
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.kernels import compress, exit_gate
    from repro_torch.kernels.compress import roundtrip, scaled_payload_nbytes
    from repro_torch.models import convnet
    from repro_torch.obs import JsonlTraceSink, full_observability
    from repro_torch.obs.check import main as check_main
    from repro_torch.offload import latency
    from repro_torch.offload.engine import convnet_engine
    from repro_torch.serving import (
        ContextualLogitsCore,
        EngineCore,
        LogitsCore,
        RuntimeConfig,
        ServingRuntime,
        constant_workload,
    )
    from repro_torch.serving import scenarios as scn

    cpu = torch.device("cpu")
    card = dev.type == "cuda"
    counters = {"exit_gate": exit_gate.KERNEL, "encode": compress.ENCODE,
                "decode": compress.DECODE}
    mark = {n: k.launches for n, k in counters.items()}
    steps = []

    def aside(fn):
        """Run a comparison's kernel launches outside the phase's counts."""
        before = {n: k.launches for n, k in counters.items()}
        fn()
        for n, k in counters.items():
            k.launches = before[n]

    def expect(step, **want):
        """The launches since the previous step must be `want` (K1 as
        exit_gate, K3 encode, K4 decode); none when `dev` is the CPU."""
        nonlocal mark
        now = {n: k.launches for n, k in counters.items()}
        got = {n: now[n] - mark[n] for n in counters}
        want = {n: want.get(n, 0) if card else 0 for n in counters}
        assert got == want, f"{step}: launches {got}, worked out {want}"
        steps.append(f"{step} {tuple(got.values())}")
        mark = now

    # -- congested Markov: BENCH_serving.json's scenario
    with open(os.path.join(ROOT, "BENCH_serving.json")) as f:
        bench = json.load(f)
    exits, final, y = scn.synthetic_cascade_logits(2048)
    t1 = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.0)] * 2)
    host = LogitsCore(exits, final, t1, device=cpu)
    say(f"congested: {near_boundary([host.conf[1], host.conf[2]], [0.8])} of 2 x 2048 "
        f"confidences within {BOUNDARY} of p_tar 0.8")
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    tmp = tmpdir.name
    for name, ctrl, p in (("static", False, t1), ("controller", True, t1),
                          ("static level 2", False, t1.with_compression(2))):
        runs, walls = {}, {}
        for where, obs_on in ((dev, False), (dev, True), (cpu, False)):
            obs = full_observability() if obs_on else None
            t0 = time.perf_counter()
            tel = scn.run_congested_markov(p, exits, final, y, n_requests=2000,
                                           with_controller=ctrl, obs=obs, device=where)
            key = f"{where.type}{' obs' if obs_on else ''}"
            walls[key] = time.perf_counter() - t0
            runs[key] = tel.summary()
            if where == dev:
                # a LogitsCore is one K1 per branch, a controller core one
                # per branch; level 2 round-trips the final logits once
                expect(f"congested {name} ({key})", exit_gate=2 + 2 * ctrl,
                       encode=int(p.compression_level != 0),
                       decode=int(p.compression_level != 0))
            if obs_on:
                paths = [os.path.join(tmp, f"{name}.{x}")
                         for x in ("trace.jsonl", "metrics.json", "audit.jsonl", "sketch.json")]
                sink = JsonlTraceSink(paths[0])
                for r in obs.trace.records:
                    sink.emit(r)
                sink.close()
                obs.metrics.write_json(paths[1])
                obs.audit.to_jsonl(paths[2])
                obs.calibration.save(paths[3])
                assert len(obs.trace) == 2000
                rc = check_main(["--trace", paths[0], "--metrics", paths[1], "--audit",
                                 paths[2], "--calibration", paths[3]])
                assert rc == 0, f"obs.check failed on the {name} artifacts"
        same_summary(runs[dev.type], runs["cpu"], f"congested {name}: {dev.type} against cpu")
        same_summary(runs[f"{dev.type} obs"], runs[dev.type], f"congested {name}: obs on/off")
        s = runs[dev.type]
        b = bench.get({"static": "static", "controller": "controller"}.get(name, ""), {})
        say(f"congested {name}, 2000 requests: p99 {s['p99_ms']:.3f} ms, miss rate "
            f"{s['deadline_miss_rate']:.4f}, offload rate {s['offload_rate']:.4f}, switches "
            f"{s['controller_switches']}"
            + (f" (BENCH_serving.json, the reference on a CPU: p99 {b['p99_ms']:.3f} ms, miss "
               f"{b['deadline_miss_rate']:.4f}, offload {b['offload_rate']:.4f})" if b else "")
            + f"; equal to the CPU port's, obs on == off, obs.check passes; host s "
            + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()), timed=True)

    tmpdir.cleanup()

    # -- distortion drift: BENCH_distortion.json's scenario
    with open(os.path.join(ROOT, "BENCH_distortion.json")) as f:
        dbench = json.load(f)
    val, test, (uncal, glob, bank) = drift
    cfg = scn.drift_controller_config()
    grid = sorted(set(cfg.p_tar_grid) | {0.8})
    arms = (("uncalibrated", uncal, None, dbench["plans"]["uncalibrated"]["summary"]
             ["miscalibration_gap"]),
            ("global", glob, None, dbench["gap_global"]),
            ("bank", bank, None, dbench["gap_bank"]),
            ("controller clean", glob, False, dbench["gap_controller_clean"]),
            ("controller context-aware", glob, True, dbench["gap_controller_context_aware"]),
            ("global level 2", glob.with_compression(2), None, None))
    band = 0
    for name, p, ctx_aware, want_gap in arms:
        # the contextual core gates one block per (context, plan key the
        # estimator can emit there, branch): its host twin counts them
        twin = ContextualLogitsCore(test["exit_logits"], test["final"], p,
                                    scn.severity_drift_schedule(), labels=test["labels"],
                                    features_by_context=test["features"], backend="numpy")
        band += near_boundary(np.concatenate(list(twin.conf.values())), grid)
        kw = {} if ctx_aware is None else dict(with_controller=True, val=val,
                                                context_aware=ctx_aware, controller_config=cfg)
        n_ctx = len(test["final"])
        t0 = time.perf_counter()
        tel = scn.run_distortion_drift(p, test, device=dev, **kw)
        wall = time.perf_counter() - t0
        level = int(getattr(p, "compression_level", 0))
        expect(f"drift {name}", exit_gate=len(twin.conf) + (0 if ctx_aware is None else
                                                           2 * (n_ctx if ctx_aware else 1)),
               encode=n_ctx * (level != 0), decode=n_ctx * (level != 0))
        host_tel = scn.run_distortion_drift(p, test, device=cpu, **kw)
        same_summary(tel.summary(), host_tel.summary(), f"drift {name}: {dev.type} against cpu")
        gap = tel.miscalibration_gap()
        say(f"drift {name}, 1500 requests: gap {gap:.4f}"
            + (f" (BENCH_distortion.json, the reference on a CPU: {want_gap:.4f})"
               if want_gap is not None else "")
            + f", accuracy {tel.accuracy:.4f}, offload rate {tel.offload_rate:.4f}; equal to "
            f"the CPU port's; {wall:.3f} s", timed=True)
    say(f"drift: {band} confidences within {BOUNDARY} of the p_tar grid {grid}")

    # -- EngineCore at full width on the trained B-AlexNet
    prof = latency.paper_2020()
    n = 512
    images = torch.as_tensor(data.test_x[:n], device=dev)
    labels = data.test_y[:n]
    reqs = constant_workload(10.0, n, n)
    for branch, level in ((1, 0), (1, 2), (2, 2)):
        pb = plan.with_partition(branch - 1, branch - 1).with_compression(level)
        engine = convnet_engine(params, pb, branch=branch, use_kernel=True, device=dev)
        ecore = EngineCore({branch: engine}, {"images": images}, labels=labels, device=dev)
        with torch.no_grad():
            logits, payload = convnet.edge_forward(params, images, branch=branch)
            final_b = convnet.cloud_forward(params, roundtrip(payload, level), from_branch=branch)
        # the batched twin: its cloud table is the cloud head on the same
        # (round-tripped) payload, priced at the codec's wire size
        lcore = LogitsCore({branch: logits}, final_b, pb.with_compression(0), labels=labels,
                           device=dev)
        expect(f"engine {branch}/{level} batched twin", exit_gate=1, encode=int(level != 0),
               decode=int(level != 0))
        times = {"engine gate": [], "engine cloud": [], "logits gate": []}
        confs = {}

        def timed(fn, key):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                times[key].append(time.perf_counter() - t0)
                if key == "engine gate":
                    confs[args[0]] = out[2]
                return out
            return call

        ecore.gate = timed(ecore.gate, "engine gate")
        ecore.cloud_predict = timed(ecore.cloud_predict, "engine cloud")
        lcore.gate = timed(lcore.gate, "logits gate")
        t_e = ServingRuntime(ecore, prof, pb, reqs, config=RuntimeConfig(max_batch=1)).run()
        n_off = sum(not r.on_device for r in t_e.records)
        assert 0 < n_off < n, n_off
        # one K1 per request; at level 2 one K3 and one K4 per offload
        expect(f"EngineCore {branch}/{level}", exit_gate=n, encode=n_off * (level != 0),
               decode=n_off * (level != 0))
        t_l = ServingRuntime(lcore, prof, pb.with_compression(0), reqs,
                             config=RuntimeConfig(max_batch=1),
                             payload_nbytes=lambda b: scaled_payload_nbytes(
                                 convnet.payload_bytes(b), level)).run()
        expect(f"LogitsCore {branch}/{level}")
        conf_l = lcore.conf[branch]
        inside = np.abs(conf_l - pb.p_tar) <= BOUNDARY
        e = {r.req_id: r for r in t_e.records}
        lo = {r.req_id: r for r in t_l.records}
        assert set(e) == set(lo) and len(e) == n
        for q in reqs:
            if inside[q.sample]:
                continue
            a, b = e[q.req_id], lo[q.req_id]
            assert a.on_device == b.on_device and a.correct == b.correct, (branch, level, q)
            assert abs(a.latency_s - b.latency_s) <= 1e-12 * b.latency_s, (branch, level, q)
        # the batch-1 confidences against the batched ones: K1 at (1, 10)
        # against K1 at (512, 10), on logits of a batch-1 and a batched
        # forward, within K1's tolerance
        ids = sorted(confs)
        np.testing.assert_allclose([confs[i] for i in ids], conf_l[ids], **K1_CONF,
                                   err_msg=f"EngineCore {branch}/{level} confidences")
        dconf = max(abs(confs[i] - conf_l[i]) for i in ids)
        offl = sorted(s for s, b in ecore._payload if b == branch)

        def batch1_against_plain():
            """Each offloaded request's kernels at its own shapes against
            their plain versions on the CPU: K1 on its (1, 10) exit logits
            (K1's tolerance, equal argmax), K3/K4 on its (1, ...) payload
            (bit for bit)."""
            for i in offl:
                with torch.no_grad():
                    z = engine.edge_step({"images": images[i:i + 1]})["exit_logits"]
                gate = engine.plan.gate  # as EngineCore.gate calls it
                got, want = gate(z, branch=engine.branch), gate(z.to(cpu), branch=engine.branch)
                np.testing.assert_allclose(to_numpy(got.confidence), to_numpy(want.confidence),
                                           **K1_CONF, err_msg=f"K1 at (1, 10), sample {i}")
                assert torch.equal(got.prediction.to(cpu), want.prediction), i
                if level:
                    x = ecore._payload[(i, branch)]
                    a, b = roundtrip(x, level).to(cpu), roundtrip(x.to(cpu), level)
                    assert a.shape == b.shape and torch.equal(
                        a.view(torch.int32), b.view(torch.int32)), f"codec at {tuple(x.shape)}"

        aside(batch1_against_plain)

        def us(key, skip=0):
            v = np.asarray(times[key][skip:]) * 1e6
            return f"{np.median(v):.1f} (mean {v.mean():.1f})"

        say(f"EngineCore branch {branch} level {level}, {n} requests: agrees with LogitsCore "
            f"on on_device, correct and latency_s ({int(inside.sum())} within {BOUNDARY} of "
            f"p_tar {pb.p_tar:.4f} left out; max |conf engine - conf batched| {dconf:.3g}, "
            f"within K1's tolerance; {len(offl)} offloaded requests' (1, 10) K1"
            + (" and payload K3/K4" if level else "") + " equal to the CPU plain version); "
            f"offloaded {n_off}, accuracy {t_e.accuracy:.4f}; host us per request: "
            f"EngineCore.gate {us('engine gate', 1)} (first {times['engine gate'][0] * 1e6:.1f}), "
            f"cloud_predict {us('engine cloud', 1)} (first batch-1 call "
            f"{times['engine cloud'][0] * 1e6:.1f}), LogitsCore.gate {us('logits gate')}",
            timed=True)

    # where an EngineCore request's time goes: 32 more requests of the last
    # engine (p_tar 2, so each one offloads) under the profiler: kernel time
    # and launches per request against the unprofiled host time above
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k = 32
    host_us = 1e6 * (np.median(times["engine gate"][1:]) + np.median(times["engine cloud"][1:]))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    _sync(dev)
    with profile(activities=activities) as profiler:
        for i in range(k):
            ecore.gate(i, branch, 2.0)
            ecore.cloud_predict(i, branch, level)
        _sync(dev)
    expect("profiled EngineCore", exit_gate=k, encode=k, decode=k)
    events = profiler.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern) / k
    top = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    say(f"profiled EngineCore branch {branch} level {level} ({k} offloaded requests): "
        f"{busy_us:.1f} us of kernels in {sum(e.count for e in kern) / k:.1f} launches per "
        f"request against {host_us:.1f} us of host time (gate + cloud_predict medians), "
        f"the device busy {busy_us / host_us:.1%}; top host ops (self us per request): "
        + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / k:.1f} x{e.count / k:g}"
                    for e in top), timed=True)
    say("launches per step (K1, K3, K4): " + "; ".join(steps))


def same_fleet_summary(a, b, keys, what):
    """Two fleet summaries agree on `keys`: latencies (``*_ms``) to rel
    1e-9, every other number equal; nan matches nan."""
    for k in keys:
        x, y = a[k], b[k]
        rel = 1e-9 if k.endswith("_ms") else 0.0
        ok = (x == y or (x != x and y != y)
              or (rel and abs(x - y) <= rel * max(abs(x), abs(y))))
        assert ok, f"{what}: {k} {x!r} against {y!r}"


def fleet_digest(tel):
    """What two fleet runs must agree on, as plain data: every cell's
    per-request columns, the fleet and per-cell summaries, the
    orchestration events and the controller's switches."""
    from repro_torch.fleet.telemetry import _CellColumns

    return {"cols": [{f: tel._cells[c].column(f) for f in _CellColumns.FIELDS}
                     for c in range(tel.n_cells)],
            "fleet": tel.fleet_summary(), "cells": tel.per_cell_summary(),
            "events": list(tel.orchestration_events), "switches": list(tel.controller_events)}


def same_digest(a, b, what, atol=0.0):
    """Two fleet digests agree: latencies to rel 1e-9 and `atol`, every
    other column equal; the summaries as `same_fleet_summary`; the same
    events and switches."""
    assert len(a["cols"]) == len(b["cols"]), what
    for c, (x, y) in enumerate(zip(a["cols"], b["cols"])):
        for f in x:
            if f == "latency_s":
                np.testing.assert_allclose(x[f], y[f], rtol=1e-9, atol=atol,
                                           err_msg=f"{what}: cell {c}")
            else:
                np.testing.assert_array_equal(x[f], y[f], err_msg=f"{what}: cell {c} {f}")
    for where, x, y in [("fleet", a["fleet"], b["fleet"])] + [
            (f"cell {c}", x, y) for c, (x, y) in enumerate(zip(a["cells"], b["cells"]))]:
        assert x.keys() == y.keys(), what
        same_fleet_summary(x, y, x, f"{what} {where}")
    assert a["switches"] == b["switches"], what
    assert a["events"] == b["events"], what


def same_fleet(tel, host, what, atol=0.0):
    """Two fleet runs agree (`same_digest`)."""
    same_digest(fleet_digest(tel), fleet_digest(host), what, atol)


#: numbers of an adversarial record computed from gate confidences
CONF_KEYS = ("ece", "mean_conf", "residual")


def same_record(a, b, key=""):
    """Two adversarial-scenario records agree field by field: decision-
    derived numbers exactly, latencies (``*_ms`` and the p99 wins'
    control / treatment) to rel 1e-9, confidence-derived ones to K1's
    tolerance; nan matches nan."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (key, a, b)
        for k in a:
            same_record(a[k], b[k], k)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (key, a, b)
        for x, y in zip(a, b):
            same_record(x, y, key)
    elif isinstance(a, float) and a != a:
        assert isinstance(b, float) and b != b, (key, a, b)
    elif isinstance(a, float) and key in CONF_KEYS:
        assert abs(a - b) <= K1_CONF["atol"] + K1_CONF["rtol"] * abs(b), (key, a, b)
    elif isinstance(a, float) and ("_ms" in key or key in ("control", "treatment")):
        assert abs(a - b) <= 1e-9 * max(abs(a), abs(b)), (key, a, b)
    else:
        assert a == b, (key, a, b)


class LaunchLog:
    """The K1/K3/K4 (and K5) launches of a phase's steps: each step's count
    worked out from the code beforehand and asserted (none off the card).
    K5 (``qk_norm_rope``) is held only at steps that give its count."""

    def __init__(self, dev):
        from repro_torch.kernels import compress, exit_gate, qk_rope

        self.card = dev.type == "cuda"
        self.counters = {"exit_gate": exit_gate.KERNEL, "encode": compress.ENCODE,
                         "decode": compress.DECODE, "qk_norm_rope": qk_rope.KERNEL}
        self.steps = []

    def now(self):
        return {n: k.launches for n, k in self.counters.items()}

    def expect(self, step, before, **want):
        got = {n: v - before[n] for n, v in self.now().items()
               if n != "qk_norm_rope" or n in want}
        want = {n: want.get(n, 0) if self.card else 0 for n in got}
        assert got == want, f"{step}: launches {got}, worked out {want}"
        self.steps.append(f"{step} {tuple(got.values())}")


def maxplus_checks(dev, say):
    """The max-plus FIFO solvers on `dev` against the oracles: the eight
    deterministic edge cases of tests/test_fleet_properties.py on dyadic
    inputs (exactly), a 1 048 576-request chain against host fifo_done
    (rel 1e-12), and k = 4 servers against kserver_oracle on a 4096-request
    prefix (exactly, dyadic); device us per call from CUDA events."""
    import torch

    from repro_torch.fleet import maxplus as mp
    from repro_torch.fleet.simulator import fifo_done

    def fifo(t, s, free=0.0):
        return mp.fifo_done_maxplus(t, s, free, device=dev)

    def exact(got, want, what):
        assert got.dtype == np.float64 and np.array_equal(got, want), what

    rng = np.random.default_rng(17)

    def dyadic(n):
        return (rng.integers(0, 512, n) * 2.0 ** -6, rng.integers(0, 64, n) * 2.0 ** -6)

    out = fifo(np.empty(0), np.empty(0))
    assert out.shape == (0,) and out.dtype == np.float64, "empty window"
    exact(fifo(np.array([3.0]), np.array([0.5])), [3.5], "single request")
    exact(fifo(np.array([1.0]), np.array([0.5]), 4.0), [4.5], "single request, busy server")
    t = np.array([0.0, 1.0, 1.0, 2.0, 5.0])
    exact(fifo(t, np.zeros(5)), t, "zero service")
    s2 = np.array([2.0, 0.0, 0.5, 0.0, 0.0])
    exact(fifo(t, s2), mp.fifo_oracle(t, s2), "zero service interleaved")
    exact(fifo(np.full(16, 2.5), np.full(16, 0.25)), 2.5 + 0.25 * np.arange(1, 17), "ties")
    sat = rng.integers(1, 32, 100) * 2.0 ** -4
    exact(fifo(np.zeros(100), sat), np.cumsum(sat), "saturated queue")
    tu, su = dyadic(64)
    rng.shuffle(tu)
    exact(fifo(tu, su), mp.fifo_oracle(tu, su), "unsorted arrivals")
    exact(fifo(np.array([0.0, 0.5, 4.0]), np.ones(3), 10.0), [11.0, 12.0, 13.0], "busy server")
    exact(mp.kserver_done_maxplus(np.array([0.0, 0.0, 1.0]), np.full(3, 2.0), 5, device=dev),
          [2.0, 2.0, 3.0], "k >= n")
    td, sd = dyadic(40)
    td.sort()
    sc = np.full(40, sd[0])
    exact(mp.kserver_done_maxplus(td, sc, 1, device=dev), fifo(td, sc), "k == 1")
    assert mp.kserver_done_maxplus(np.empty(0), np.empty(0), 3, device=dev).shape == (0,)
    for _ in range(50):  # and dyadic chains with a free time, as the property sweep
        n = int(rng.integers(1, 129))
        tr, sr = dyadic(n)
        free = float(rng.integers(0, 256)) * 2.0 ** -6
        exact(fifo(tr, sr, free), mp.fifo_oracle(tr, sr, free), "dyadic sweep")

    # BENCH_fleet.json's fleet_compiled scale: one 1 048 576-request chain
    n = 1 << 20
    t = np.cumsum(rng.exponential(1.0 / 9000.0, n))
    s = rng.uniform(2e-5, 2e-4, n)
    t0 = time.perf_counter()
    host = fifo_done(t, s, 0.5)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = fifo(t, s, 0.5)
    call_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(got - host) / host))
    assert rel <= 1e-12, f"1M chain: max rel {rel:.3g} against host fifo_done"
    tk, _ = dyadic(4096)
    tk.sort()
    sk = np.full(4096, 7 * 2.0 ** -6)
    exact(mp.kserver_done_maxplus(tk, sk, 4, device=dev), mp.kserver_oracle(tk, sk, 4),
          "k = 4 on a 4096-request prefix")
    # k = 4 over the whole chain at a dyadic service time (9/128 s), so the
    # running sums are exact and the four residue chains equal host fifo_done
    cloud = np.full(n, 9 * 2.0 ** -7)
    want = np.empty(n)
    for r in range(4):
        want[r::4] = fifo_done(t[r::4], cloud[r::4], 0.0)
    exact(mp.kserver_done_maxplus(t, cloud, 4, device=dev), want, "1M chain, k = 4")

    timing = ""
    if dev.type == "cuda":
        tt = torch.as_tensor(t, device=dev)
        ss = torch.as_tensor(s, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        rows = n // 4
        t2, m2 = tt.reshape(rows, 4), mask.reshape(rows, 4)
        c2 = torch.full((rows, 4), 9 * 2.0 ** -7, dtype=torch.float64, device=dev)
        # the compiled fleet's layout: one chain per cell lane, the
        # reference fleet's 1600 requests per cell by 64 cells
        lanes = (1600, 64)
        tl = torch.as_tensor(np.cumsum(rng.exponential(0.05, lanes), axis=0), device=dev)
        sl = torch.as_tensor(rng.uniform(2e-3, 2e-2, lanes), device=dev)
        ml = torch.ones(lanes, dtype=torch.bool, device=dev)
        tlt, slt, mlt = tl.T.contiguous(), sl.T.contiguous(), ml.T.contiguous()

        def inner(t, s, m):
            """The same closed form scanned along the innermost axis of the
            (cells, requests) layout, for comparison only."""
            a = torch.where(m, s, torch.zeros_like(s))
            acc = torch.cumsum(a, dim=1)
            x = torch.where(m, t - (acc - a), torch.full_like(t, -torch.inf))
            return acc + torch.cummax(x, dim=1).values.clamp(min=0.0)

        lane_ref = mp.maxplus_fifo(tl, sl, ml, 0.0)
        lane_rel = float(((inner(tlt, slt, mlt).T - lane_ref).abs() / lane_ref).max())
        assert lane_rel <= 1e-12, f"(1600, 64) lanes: innermost against axis 0, rel {lane_rel:.3g}"

        def device_us(fn, reps=20):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) * 1e3)
            return float(np.median(times))

        chain_us = device_us(lambda: mp.maxplus_fifo(tt, ss, mask, 0.5))
        k4_us = device_us(lambda: mp.maxplus_fifo(t2, c2, m2, 0.0), reps=3)
        lane_us = device_us(lambda: mp.maxplus_fifo(tl, sl, ml, 0.0))
        lane_inner = device_us(lambda: inner(tlt, slt, mlt))
        timing = (f"; device us per maxplus_fifo call (CUDA events, median, tensors on the "
                  f"card): 1M chain {chain_us:.1f}, its k = 4 view {k4_us:.1f}, (1600, 64) "
                  f"lanes {lane_us:.1f} (scanned along the innermost axis of their "
                  f"transpose: {lane_inner:.1f}); bounds (t, s in, done out) "
                  f"{n * 8 * 3 / HBM_BYTES_PER_S * 1e6:.2f} and "
                  f"{lanes[0] * lanes[1] * 8 * 3 / HBM_BYTES_PER_S * 1e6:.3f}")
    say(f"maxplus: 8 edge cases and 50 dyadic chains equal the oracle exactly; "
        f"1 048 576-request chain max rel {rel:.3g} against host fifo_done "
        f"({host_s * 1e3:.2f} ms numpy), k = 4 over it equal to four host chains; host ms per "
        f"fifo_done_maxplus call with its copies {call_s * 1e3:.2f}" + timing, timed=True)


def fleet_phase(dev, val, test, plans, n_cells=64, twin_cells=64, say=print):
    """The fleet simulator and the orchestration plane on `dev`, every run
    held against the same run of the CPU port with the "numpy" backend;
    the launches of every run asserted. `plans` is (uncalibrated, global,
    bank), fit on `dev` from `val`. Returns each arm's fleet summary."""
    import torch

    from repro_torch.core.gatepath import GateTable, TorchGateBackend
    from repro_torch.fleet import FleetController, FleetControllerConfig
    from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
    from repro_torch.offload import latency
    from repro_torch.orchestration import run_scenarios
    from repro_torch.orchestration.scenarios import _drift_data

    cpu = torch.device("cpu")
    log = LaunchLog(dev)
    launches, expect = log.now, log.expect
    summaries = {}

    maxplus_checks(dev, say)

    with open(os.path.join(ROOT, "BENCH_fleet.json")) as f:
        bench = json.load(f)
    uncal, glob, bank = plans
    gate = TorchGateBackend(device=dev)
    n_ctx = len(test["final"])
    grid = (0.3, 0.5, 0.7, 0.8)  # the plans' p_tar and the controller grid
    codec_cfg = FleetControllerConfig(  # benchmarks/run.py's _comp_fleet_arm((0, 1, 2))
        interval_s=1.0, window_s=2.0, p_tar_grid=grid, min_accuracy=0.8, cloud_rho_max=0.9,
        compression_levels=(0, 1, 2))
    arms = (("static_uncalibrated", uncal, {}),
            ("expert_bank_static", bank, {}),
            ("expert_bank_controller", bank, dict(with_controller=True)),
            ("compression_aware", bank, dict(with_controller=True,
                                             controller_config=codec_cfg)),
            ("global_level2", glob.with_compression(2), {}))
    scn = reference_fleet(n_cells=n_cells, val=val, test=test)
    twin_scn = scn if twin_cells == n_cells else reference_fleet(n_cells=twin_cells, val=val,
                                                                 test=test)
    # confidences near a p_tar the runs visit: the host twins of the gate
    # tables and of the controller's validation blocks (no launch)
    band = sum(near_boundary(fleet_gate_table(p, scn, backend="numpy").conf, grid)
               for p in (uncal, bank, glob))
    ctrl = FleetController(bank, latency.paper_2020(), val["exit_logits"], n_cells=1,
                           final_logits=val["final"], labels=val["labels"], backend="numpy")
    band += near_boundary(np.concatenate([c for c, _ in ctrl.core._exit_stats]), grid)
    say(f"{band} confidences of the fleet's gate tables and the controller's validation "
        f"blocks within {BOUNDARY} of the p_tars {grid}")
    topo = scn.topology
    windows = int(np.ceil(topo.horizon_s / 0.5)) + 1
    say(f"reference fleet: {topo.n_cells} cells, {topo.n_requests} requests, "
        f"{topo.cloud_servers} cloud servers, paper_2020, 0.5 s windows ({windows} per run)")
    levels_asked = []
    cloud_pred = GateTable.cloud_pred

    def recording(self, ctx_ids, samples, level=0):
        if int(level) not in self._final_pred_by_level:
            levels_asked.append(int(level))
        return cloud_pred(self, ctx_ids, samples, level)

    GateTable.cloud_pred = recording
    try:
        for name, p, kw in arms:
            before = launches()
            del levels_asked[:]
            t0 = time.perf_counter()
            tel = run_fleet(p, scn, backend=gate, **kw)
            wall = time.perf_counter() - t0
            asked = sorted(levels_asked)
            # a gate table is one K1 per (context, branch); a controller core
            # one per (branch, context) and one K3 + K4 round trip of the
            # validation finals per non-zero codec level; the table's cloud
            # predictions one K3 + K4 per context and per new non-zero level
            ctrl_levels = kw.get("controller_config", FleetControllerConfig()).compression_levels
            codec = (len([lv for lv in (ctrl_levels or ()) if lv])
                     * bool(kw.get("with_controller")) + n_ctx * len(asked))
            expect(f"{name} ({dev.type})", before,
                   exit_gate=2 * n_ctx * (1 + bool(kw.get("with_controller"))),
                   encode=codec, decode=codec)
            before = launches()
            t0 = time.perf_counter()
            host = run_fleet(p, twin_scn, backend="numpy", **kw)
            host_wall = time.perf_counter() - t0
            expect(f"{name} (cpu)", before)
            if twin_cells == n_cells:
                same_fleet(tel, host, f"{name}: {dev.type} against cpu")
                held = "equal to the CPU port's (numpy backend)"
            else:
                small = run_fleet(p, twin_scn, backend=gate, **kw)
                same_fleet(small, host, f"{name}: {twin_cells} cells, {dev.type} against cpu")
                held = f"the {twin_cells}-cell twin equal to the CPU port's"
            s = summaries[name] = tel.fleet_summary()
            ref = (bench["plans"].get(name, {}).get("fleet")
                   or bench["compression"].get(name))
            if ref is not None:
                missing = ref.keys() - s.keys()
                assert not missing, f"{name}: the summary lacks {sorted(missing)}"
                same_fleet_summary(s, ref, ref, f"{name} against BENCH_fleet.json")
                exact = all(s[k] == ref[k] for k in ref)
                cited = (f" (BENCH_fleet.json, the reference on a CPU: p99 {ref['p99_ms']:.3f} ms,"
                         f" gap {ref['miscalibration_gap']:.4f}; every summary number equal"
                         + ("" if exact else ", latencies to rel 1e-9") + ")")
            else:
                cited = ""
            say(f"{name}: p99 {s['p99_ms']:.3f} ms, gap {s['miscalibration_gap']:.4f}, "
                f"accuracy {s['accuracy']:.4f}, offload rate {s['offload_rate']:.4f}, "
                f"switches {s['controller_switches']}{cited}; {held}; codec levels of the "
                f"cloud tables {asked or 'none'}; host s per run: "
                f"{dev.type} {wall:.3f}, cpu {host_wall:.3f} ({windows} windows)", timed=True)
    finally:
        GateTable.cloud_pred = cloud_pred

    # the adversarial matrix: quick scenarios, plans fit on each device
    before = launches()
    t0 = time.perf_counter()
    recs = run_scenarios(quick=True, device=dev)
    wall = time.perf_counter() - t0
    # K1 blocks per scenario, each one K1 per (context, branch): the bank
    # fit's validation gate, one gate table per run and per rollout
    # candidate, one controller core per controller run; no codec level
    blocks = {"weather_front": 1 + 2 + 1, "flash_crowd": 1 + 2 + 1,
              "link_outage": 1 + 2 + 1, "cloud_brownout": 1 + 2 + 1,
              "poisoned_canary": 1 + 3 + 1, "good_rollout": 1 + 2 + 1}
    assert [r["name"] for r in recs] == list(blocks), [r["name"] for r in recs]
    n_mat = len(_drift_data(0)[1]["final"])
    expect("adversarial matrix", before, exit_gate=2 * n_mat * sum(blocks.values()))
    before = launches()
    t0 = time.perf_counter()
    host = run_scenarios(quick=True, device=cpu)
    host_wall = time.perf_counter() - t0
    expect("adversarial matrix (cpu)", before)
    assert [r["name"] for r in recs] == [r["name"] for r in host]
    for r, h in zip(recs, host):
        same_record(r, h, r["name"])
        assert r["pass"], f"scenario {r['name']} failed: {r['wins']}"
    say(f"adversarial matrix (quick, 8 cells): {', '.join(r['name'] for r in recs)} all pass; "
        f"records equal to the CPU port's field by field; host s {dev.type} {wall:.3f}, cpu "
        f"{host_wall:.3f}", timed=True)
    say("launches per run (K1, K3, K4): " + "; ".join(log.steps))
    return summaries


def same_trace(recs, other, what):
    """Two sampled traces: the same records, floats to rel 1e-9 / abs
    1e-12 (span edges come from the latencies), the rest equal."""
    assert len(recs) == len(other) > 0, what

    def check(a, b, path):
        if isinstance(a, dict):
            assert isinstance(b, dict) and a.keys() == b.keys(), (what, path)
            for k in a:
                check(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), (what, path)
            for i, (x, y) in enumerate(zip(a, b)):
                check(x, y, f"{path}[{i}]")
        elif isinstance(a, float) and not isinstance(a, bool):
            assert abs(a - b) <= 1e-12 + 1e-9 * abs(b), (what, path, a, b)
        else:
            assert a == b, (what, path, a, b)

    for a, b in zip(recs, other):
        check(a, b, f"req {a['req_id']}")


def compiled_phase(dev, val, test, plans, fleet_summaries, n_cells=64, small=(6, 200),
                   scale=(256, 1024), say=print):
    """The compiled fleet pipeline (`repro_torch.fleet.compiled`) on `dev`:
    BENCH_fleet.json's 64-cell fleet in three arms, each held to the host
    FleetSimulator on the same table on `dev` and to the bench (to phase
    9's run where the bench holds no summary); churn, a whole-fleet outage,
    the QoS monitor and full observability at `small` cells x requests
    (2 cloud servers), each through run_fleet against the host run; the
    scope limits; the scale arm, `scale` cells x requests, against the
    host simulator with the "numpy" backend. Host s and device ms per
    stage, the device's idle share over one profiled run, and the
    launches of every run asserted. `plans` is phase 9's."""
    import torch

    from repro_torch.core.gatepath import TorchGateBackend
    from repro_torch.fleet import CompiledFleetSimulator, CompiledGateBackend, FleetConfig
    from repro_torch.fleet import FleetSimulator
    from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
    from repro_torch.obs import full_observability
    from repro_torch.obs.check import run_checks
    from repro_torch.offload import latency
    from repro_torch.orchestration import ChurnSchedule, Orchestrator, RolloutManager
    from repro_torch.orchestration.qos import CellSLO, QoSConfig, QoSMonitor

    log = LaunchLog(dev)
    comp, gate = CompiledGateBackend(device=dev), TorchGateBackend(device=dev)
    profile, cfg = latency.paper_2020(), FleetConfig(window_s=0.5)
    n_ctx = len(test["final"])
    with open(os.path.join(ROOT, "BENCH_fleet.json")) as f:
        bench = json.load(f)
    uncal, glob, bank = plans

    def stages(sim):
        host = ", ".join(f"{k} {v:.3f}" for k, v in sim.host_s.items())
        dev_ms = (", ".join(f"{k} {v:.3f}" for k, v in sim.stage_ms.items())
                  if sim.stage_ms else "not measured off the card")
        return f"host s: {host}; device ms per stage (CUDA events): {dev_ms}"

    # ---- the 64-cell reference fleet, three static arms
    scn = reference_fleet(n_cells=n_cells, val=val, test=test)
    topo = scn.topology
    say(f"reference fleet: {topo.n_cells} cells, {topo.n_requests} requests, "
        f"{topo.cloud_servers} cloud servers, 0.5 s windows")
    tables, tels = {}, {}
    for name, p in (("expert_bank_static", bank), ("static_uncalibrated", uncal),
                    ("global_level2", glob.with_compression(2))):
        before = log.now()
        t0 = time.perf_counter()
        table = tables[name] = fleet_gate_table(p, scn, backend=comp)
        table_s = time.perf_counter() - t0
        sim = CompiledFleetSimulator(table, topo, profile, config=cfg)
        t0 = time.perf_counter()
        tel = sim.run()
        wall = time.perf_counter() - t0
        # the table: one K1 per (context, branch); the cloud predictions one
        # K3 + K4 per context at a non-zero level; the program none
        codec = n_ctx * bool(getattr(p, "compression_level", 0))
        log.expect(f"{name} compiled", before, exit_gate=2 * n_ctx, encode=codec,
                   decode=codec)
        before = log.now()
        t0 = time.perf_counter()
        host = FleetSimulator(table, topo, profile, config=cfg).run()
        host_wall = time.perf_counter() - t0
        log.expect(f"{name} host", before)  # the same table: nothing new
        same_fleet(tel, host, f"{name}: compiled against host", atol=1e-12)
        tels[name] = tel
        s = tel.fleet_summary()
        ref = bench["plans"].get(name, {}).get("fleet")
        if n_cells != 64:
            cited = ""
        elif ref is not None:
            same_fleet_summary(s, ref, ref, f"{name} against BENCH_fleet.json")
            cited = (f" (BENCH_fleet.json, the reference on a CPU: p99 {ref['p99_ms']:.3f} ms, "
                     f"gap {ref['miscalibration_gap']:.4f}; every summary number equal, "
                     f"latencies to rel 1e-9)")
        else:
            prev = fleet_summaries[name]
            same_fleet_summary(s, prev, prev, f"{name} against phase 9")
            cited = " (no summary in BENCH_fleet.json; equal to phase 9's run)"
        say(f"{name}: p99 {s['p99_ms']:.3f} ms, gap {s['miscalibration_gap']:.4f}, accuracy "
            f"{s['accuracy']:.4f}, offload rate {s['offload_rate']:.4f}{cited}; columns equal "
            f"to the host simulator's on the same table; host s per run: compiled {wall:.3f}, "
            f"host {host_wall:.3f} (table {table_s:.3f}); compiled {stages(sim)}", timed=True)

    # ---- the device's idle share over one compiled run (bank, 64 cells)
    sim = CompiledFleetSimulator(tables["expert_bank_static"], topo, profile, config=cfg)
    _sync(dev)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    if log.card:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        before = log.now()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            psim = CompiledFleetSimulator(tables["expert_bank_static"], topo, profile,
                                          config=cfg)
            psim.run()
            _sync(dev)
        log.expect("profiled compiled run", before)
        kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy_s = sum(e.self_device_time_total for e in kern) / 1e6
        say(f"profiled compiled run (expert bank, {n_cells} cells): {busy_s * 1e3:.3f} ms of "
            f"device time in {sum(e.count for e in kern)} kernels and copies; against the "
            f"unprofiled run's {wall:.3f} s the device is {1 - busy_s / wall:.1%} idle, against "
            f"its program span ({sim.host_s['program']:.3f} s: upload, program, sync, download) "
            f"{1 - busy_s / sim.host_s['program']:.1%}; the unprofiled run's {stages(sim)}; "
            f"top: " + "; ".join(
                f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                for e in kern[:6]), timed=True)
    else:
        say(f"idle share: not measured off the card (the run took {wall:.3f} s)")

    # ---- orchestration and observability at the tests' size, through
    # run_fleet, each against the host run on `dev`
    sscn = reference_fleet(n_cells=small[0], requests_per_cell=small[1], val=val, test=test,
                           cloud_servers=2)
    all_cells = list(range(small[0]))

    def outage(cells, start, duration):
        return lambda: Orchestrator(churn=ChurnSchedule.outage(cells, start_s=start,
                                                               duration_s=duration))

    def qos():
        return Orchestrator(monitor=QoSMonitor(
            CellSLO(p99_ms=1e-3, min_requests=1),
            QoSConfig(window_s=2.0, trip_after=1, clear_after=1000)))

    runs = (("churn shed", outage([0, 2], 2.0, 2.0), None),
            ("whole-fleet outage", outage(all_cells, 1.0, 2.0), None),
            ("QoS monitor", qos, None),
            ("observability", None, 7),
            ("observability, churn", outage([0, 2], 2.0, 4.0), 1),
            ("observability, outage", outage(all_cells, 2.0, 3.0), 1))
    done = []
    for name, orch, every in runs:
        out = []
        for backend in (comp, gate):
            obs = None if every is None else full_observability(trace_sample_every=every)
            before = log.now()
            tel = run_fleet(bank, sscn, backend=backend, orchestrator=orch and orch(), obs=obs)
            log.expect(f"{name} {backend.name}", before, exit_gate=2 * n_ctx)
            out.append((tel, obs))
        (tel, obs), (host, hobs) = out
        same_fleet(tel, host, f"{name}: compiled against host", atol=1e-12)
        kinds = sorted({k for _, k, _ in tel.orchestration_events})
        if name == "QoS monitor":
            assert "qos_trip" in kinds, kinds
        if obs is not None:
            assert run_checks(obs.trace.records, obs.metrics, obs.audit.records) == [], name
            same_trace(obs.trace.records, hobs.trace.records, name)
            for c in ("fleet_requests_total", "fleet_offloaded_total", "fleet_shed_total",
                      "fleet_uplink_bytes_total"):
                assert obs.metrics.counter_total(c) == hobs.metrics.counter_total(c), (name, c)
            a, b = obs.calibration._blocks, hobs.calibration._blocks
            assert a.keys() == b.keys() and a, name
            for key in a:  # count rows equal; confidence sums to rel 1e-12
                assert np.array_equal(a[key][[0, 1, 5, 6]], b[key][[0, 1, 5, 6]]), (name, key)
                np.testing.assert_allclose(a[key][2:5], b[key][2:5], rtol=1e-12, atol=0)
        done.append(f"{name} (events {kinds or 'none'})")
    # the scope limits raise before anything is built
    before = log.now()
    rollout = Orchestrator(monitor=QoSMonitor(CellSLO(p99_ms=1e3)), rollout=RolloutManager(
        bank.bumped(), lambda b: b, canary_cells=(0,)))
    for kw, match in ((dict(with_controller=True), "static deployment"),
                      (dict(orchestrator=rollout), "does not support canary rollouts")):
        try:
            run_fleet(bank, sscn, backend=comp, **kw)
        except ValueError as e:
            assert match in str(e), e
        else:
            raise AssertionError(f"the compiled pipeline accepted {sorted(kw)}")
    log.expect("scope limits", before)
    say(f"{small[0]} cells x {small[1]} requests, 2 cloud servers, each through run_fleet and "
        f"equal to the host run (sampled traces, counters, the sketch's counts; its "
        f"confidence sums to rel 1e-12), obs.check clean: " + ", ".join(done)
        + "; a controller and a rollout raise")

    # ---- the scale arm: benchmarks/run.py's fleet_compiled.scale
    t0 = time.perf_counter()
    big = reference_fleet(n_cells=scale[0], requests_per_cell=scale[1], val=val, test=test)
    scn_s = time.perf_counter() - t0
    before = log.now()
    table = fleet_gate_table(bank, big, backend=comp)
    sim = CompiledFleetSimulator(table, big.topology, profile, config=cfg)
    t0 = time.perf_counter()
    tel = sim.run()
    wall = time.perf_counter() - t0
    first = stages(sim)
    t0 = time.perf_counter()
    again = sim.run()  # the same run at shapes the card has now seen
    wall2 = time.perf_counter() - t0
    log.expect("scale compiled (two runs)", before, exit_gate=2 * n_ctx)
    same_fleet(again, tel, "scale: compiled run against itself", atol=1e-12)
    before = log.now()
    t0 = time.perf_counter()
    host = run_fleet(bank, big, backend="numpy")
    host_wall = time.perf_counter() - t0
    log.expect("scale numpy", before)
    same_fleet(tel, host, "scale: compiled against numpy", atol=1e-12)
    s = tel.fleet_summary()
    n = big.topology.n_requests
    say(f"scale arm: {scale[0]} cells x {scale[1]} = {n} requests (scenario built in "
        f"{scn_s:.2f} s): p99 {s['p99_ms']:.3f} ms, gap {s['miscalibration_gap']:.4f}, offload "
        f"rate {s['offload_rate']:.4f}; columns and summaries equal to the host simulator's "
        f"(numpy backend), latencies to rel 1e-9; host s per run: compiled {wall:.3f} "
        f"({n / wall:.0f} requests/s), again {wall2:.3f}, numpy {host_wall:.3f} "
        f"({n / host_wall:.0f} requests/s); compiled, first run: {first}; again: {stages(sim)}",
        timed=True)
    say("launches per run (K1, K3, K4): " + "; ".join(log.steps))
    return {"global_level2": tels["global_level2"], "scale": tel}


def lm_reductions(cfg, n_layers, seq=None):
    """Reduction lengths of the float32 sums that feed an output after
    `n_layers` blocks and a head: per attention block the norm, the q/k/v
    and output projections and the scores; per mamba block the norm,
    in_proj, the causal conv, the SSD scan's sums over the state (C.B and
    C.S) and over a chunk (the intra-chunk product and the chunk's input
    state; the chunk is min(ssm_chunk, seq)), the gated norm and out_proj;
    per dense ffn the norm and the MLP's two products; per MoE ffn the
    norm, the router, the expert's two products and the top-k combine;
    then the head's norm and unembedding."""
    d, out = cfg.d_model, []
    chunk = min(cfg.ssm_chunk, seq or cfg.ssm_chunk)
    for mixer, ffn in cfg.layer_plan()[:n_layers]:
        if mixer == "attn":
            out += [d, d, cfg.head_dim, cfg.num_heads * cfg.head_dim]
        else:
            out += [d, d, cfg.ssm_conv, cfg.ssm_state, chunk, chunk, cfg.ssm_state,
                    cfg.d_inner, cfg.d_inner]
        if ffn == "dense":
            out += [d, d, cfg.d_ff]
        elif ffn == "moe":
            out += [d, d, d, cfg.moe_d_ff, cfg.moe_top_k]
    return out + [d, d]


def lm_profile(dev, cfg, params, plan, tokens, decode, log, say):
    """Where a prefill step's and a decode step's time goes on the card:
    the attention calls' share (CUDA events around every
    `attention_prefill` / `attention_decode` call of one prefill step and
    of 4 decode steps, against events around the steps), and the device's
    busy share of a decode step (`torch.profiler` over 4 more steps:
    kernel time and launches a step against the host time a step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import attention, registry

    spans = []

    def timed(fn):
        def run(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            res = fn(*args, **kw)
            b.record()
            spans.append((a, b))
            return res
        return run

    def span_ms(pairs):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs)

    prefill = make_prefill_step(cfg, plan=plan, device=dev)
    serve_step = make_serve_step(cfg, plan=plan, device=dev)
    n_dec = 4
    k5 = k5_launches(cfg, 0, cfg.num_layers)
    saved = attention.attention_prefill, attention.attention_decode
    attention.attention_prefill, attention.attention_decode = timed(saved[0]), timed(saved[1])
    try:
        whole = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))]
        before = log.now()
        whole[0][0].record()
        prefill(params, {"tokens": tokens})
        whole[0][1].record()
        log.expect("profiled prefill", before, exit_gate=len(cfg.exit_layers), qk_norm_rope=k5)
        pre_ms, pre_attn = span_ms(whole), span_ms(spans)
        spans.clear()
        caches = registry.init_cache(cfg, tokens.shape[0], decode, device=dev)
        tok = tokens[:, :1]
        whole = []
        for t in range(n_dec):
            whole.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            before = log.now()
            whole[-1][0].record()
            o, caches = serve_step(params, tok, caches, t)
            whole[-1][1].record()
            log.expect("profiled decode", before, exit_gate=len(cfg.exit_layers),
                       qk_norm_rope=k5)
            tok = o["token"][:, None]
        dec_ms, dec_attn = span_ms(whole) / n_dec, span_ms(spans) / n_dec
    finally:
        attention.attention_prefill, attention.attention_decode = saved
    say(f"attention's share (CUDA events): prefill {tokens.shape[0]} x {tokens.shape[1]} "
        f"{pre_attn:.3f} of {pre_ms:.3f} ms ({pre_attn / pre_ms:.1%}); decode step at batch "
        f"{tokens.shape[0]} {dec_attn:.3f} of {dec_ms:.3f} ms ({dec_attn / dec_ms:.1%})",
        timed=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(n_dec, 2 * n_dec):
            before = log.now()
            o, caches = serve_step(params, tok, caches, t)
            log.expect("profiled decode", before, exit_gate=len(cfg.exit_layers),
                       qk_norm_rope=k5)
            tok = o["token"][:, None]
        torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n_dec
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / (1e3 * n_dec)
    launches = sum(e.count for e in kern) / n_dec
    say(f"profiled decode step: {busy:.3f} ms of kernels in {launches:.0f} launches a step: "
        f"{1 - busy / dec_ms:.1%} idle against the {dec_ms:.3f} ms step above, "
        f"{1 - busy / host_ms:.1%} against the {host_ms:.3f} ms a step under the profiler; top: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total / (1e3 * n_dec):.3f} ms "
                    f"x{e.count // n_dec}" for e in kern[:5]), timed=True)
    return dict(prefill_ms=pre_ms, prefill_attn_ms=pre_attn, decode_ms=dec_ms,
                decode_attn_ms=dec_attn, decode_busy_ms=busy, decode_launches=launches,
                decode_host_ms=host_ms)


def lm_phase(dev, cfg, val=(128, 256), serve=(8, 512), n_serve=3, decode=32, eq=(2, 16),
             cross=(2, 32), n_tokens=100_000, say=print):
    """The language-model serving path (`repro_torch.launch.serve`,
    `offload.engine.lm_engine`) on `dev` at `cfg` (Qwen3-8B at full width
    and depth on the card) from a seeded bf16 init; returns the printed
    numbers. `val` is the (batch, seq) of the plans' validation windows,
    `serve` that of a prefill step and of an lm_engine batch, `decode` the
    decoded tokens, `eq` and `cross` the (batch, seq) of the float32
    checks at 4 layers (decode against forward_train) and at 2 layers
    (`dev` against the CPU)."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.core.calibration import nll
    from repro_torch.core.policy import make_plan
    from repro_torch.data.pipeline import TokenIterator
    from repro_torch.data.synthetic import lm_sequences
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.compress import scaled_payload_nbytes
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import registry, transformer
    from repro_torch.offload.engine import EngineStats, lm_engine

    card = dev.type == "cuda"
    log = LaunchLog(dev)
    out = {}
    n_exits = len(cfg.exit_layers)
    # K5's launches: every layer in a whole-model step, the layers up to
    # exit 0 in the engine's edge call and the rest in its cloud call
    k5_all = k5_launches(cfg, 0, cfg.num_layers)
    k5_edge = k5_launches(cfg, 0, cfg.exit_layers[0] + 1)

    def mem():
        if not card:
            return "memory not measured (CPU)"
        return (f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    # ---- init: the seeded model at full width and depth
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    _sync(dev)
    n = transformer.num_params(params)
    # param_count() leaves out the final norm's scale and the qk-norm scales
    want = cfg.param_count() + cfg.d_model + (2 * cfg.head_dim * cfg.num_layers
                                              if cfg.qk_norm else 0)
    assert n == want, (n, want)
    say(f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"segments (layers, exit after) {[(g[1], g[2]) for g in transformer.segment_plan(cfg)]}; "
        f"seeded {cfg.dtype} init of {n} scalars (param_count {cfg.param_count()}) in "
        f"{time.perf_counter() - t0:.2f} s; {mem()}", timed=True)
    out["params"] = n

    # ---- plans: validation windows, both exits' last-position logits
    t0 = time.perf_counter()
    stream = lm_sequences(n_tokens, cfg.vocab_size, seed=0)
    vb = next(iter(TokenIterator(stream, val[0], val[1], seed=0)))
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunks = []
    with torch.no_grad():
        for i in range(0, val[0], 32):
            o = registry.forward_prefill(params, cfg, {"tokens": torch.as_tensor(
                vb["tokens"][i:i + 32], device=dev)})
            chunks.append([z[:, 0] for z in o["exit_logits"]])
            del o
    zs = [torch.cat([c[i] for c in chunks]) for i in range(n_exits)]
    del chunks
    _sync(dev)
    y = torch.as_tensor(vb["labels"][:, -1], device=dev)
    say(f"validation: {val[0]} x {val[1]} windows of lm_sequences({n_tokens}) through "
        f"TokenIterator ({t_data:.2f} s, numpy); both exits' last-position logits "
        f"{tuple(zs[0].shape)} {str(zs[0].dtype)[6:]} in {time.perf_counter() - t0:.2f} s; "
        f"{mem()}", timed=True)
    t0 = time.perf_counter()
    plan_u = make_plan(zs, y, p_tar=0.5, calibrated=False)
    plan_c = make_plan(zs, y, p_tar=0.5)
    t_plain = plan_c.temperatures
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    t_k2 = [float(ops.fit_temperature_kernel(z, y)[0]) for z in zs]  # K2 on bf16 (n, vocab)
    t_k2_s = time.perf_counter() - t0
    # a seeded model knows nothing of the token labels, so the NLL is flat
    # in T near its minimum: the two fits are held to reach the same NLL
    # (to float32 resolution), not the same T
    nlls = [(float(nll(z.float(), y, a)), float(nll(z.float(), y, b)))
            for z, a, b in zip(zs, t_k2, t_plain)]
    for a, b in nlls:
        assert abs(a - b) <= 1e-6 * abs(b), ("K2 and the plain fit reach different NLLs", nlls)
    say(f"T per exit on the token labels: plain fit (make_plan) "
        f"{[round(t, 6) for t in t_plain]} in {t_fit:.2f} s; K2 Newton fit "
        f"{[round(t, 6) for t in t_k2]} in {t_k2_s:.2f} s; NLL at each (K2, plain) "
        f"{[(round(a, 7), round(b, 7)) for a, b in nlls]}", timed=True)
    # the same two fits on labels drawn from softmax(z / 1.5) of exit 0,
    # eight per validation row, so that there is a temperature to find;
    # held as phase 6 holds them, to rel 1e-3 in T
    gen = torch.Generator(device=dev).manual_seed(1)
    zp = zs[0].repeat(8, 1)
    yp = torch.multinomial(torch.softmax(zp.float() / 1.5, dim=-1), 1, generator=gen)[:, 0]
    tk_p = float(ops.fit_temperature_kernel(zp, yp)[0])
    tr_p = float(make_plan([zp], yp, p_tar=0.5).temperatures[0])
    say(f"planted T* = 1.5 on exit 0's logits {tuple(zp.shape)} {str(zp.dtype)[6:]}: "
        f"K2 fit {tk_p:.6f}, plain fit {tr_p:.6f}")
    assert abs(tk_p - tr_p) <= 1e-3 * tr_p and 1.2 < tr_p < 1.9, (tk_p, tr_p)
    del zp, yp
    out["t_plain"], out["t_k2"], out["t_planted"] = t_plain, t_k2, (tk_p, tr_p)

    def p_tar_for(plan):
        """The midpoint of the two middle calibrated confidences of exit 0
        on the validation rows (an even count): both outcomes occur."""
        c = torch.sort(ref.exit_gate_ref(plan.calibrated_logits(zs[0], 0), 1.0)[0].double())[0]
        return float((c[len(c) // 2 - 1] + c[len(c) // 2]) / 2)

    plan_u = plan_u.with_p_tar(p_tar_for(plan_u))
    plan_c = plan_c.with_p_tar(p_tar_for(plan_c))
    say(f"plans: uncalibrated p_tar {plan_u.p_tar:.9g}; calibrated (T {t_plain}) p_tar "
        f"{plan_c.p_tar:.9g}")
    del zs

    # ---- prefill and decode through the serving steps: every exit's K1
    # gate held against the plain gate on the same logits, and the plan
    # path against the temperatures= path
    serve_it = iter(TokenIterator(stream, serve[0], serve[1], seed=1))
    batches = [torch.as_tensor(next(serve_it)["tokens"], device=dev) for _ in range(n_serve)]
    gaps = {"conf_rel": 0.0, "conf_abs": 0.0, "plan_vs_temps": 0.0, "clear": 0, "rows": 0}

    def hold(conf, pred, logits, plan, what):
        for i, z in enumerate(logits):
            zc = plan.calibrated_logits(z, i)
            rc, _, ri = ref.exit_gate_ref(zc, 1.0)
            torch.testing.assert_close(conf[i], rc, **K1_CONF, msg=lambda m: f"{what}: {m}")
            top2 = torch.topk(zc.float(), 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-6 * top2[:, 0].abs()
            assert torch.equal(pred[i][clear], ri[clear]), f"{what}: K1 argmax differs"
            gaps["conf_rel"] = max(gaps["conf_rel"], float(((conf[i].double() - rc.double()).abs()
                                                            / rc.double()).max()))
            gaps["conf_abs"] = max(gaps["conf_abs"], float((conf[i] - rc).abs().max()))
            gaps["clear"] += int(clear.sum())
            gaps["rows"] += int(clear.numel())

    for plan, tag in ((plan_u, "uncalibrated"), (plan_c, "calibrated")):
        prefill = make_prefill_step(cfg, plan=plan, device=dev)
        prefill_t = make_prefill_step(cfg, temperatures=plan.temperatures, device=dev)
        before = log.now()
        prefill(params, {"tokens": batches[0]})  # warm-up
        _sync(dev)
        log.expect(f"{tag} prefill warm-up", before, exit_gate=n_exits, qk_norm_rope=k5_all)
        times = []
        for b in batches:
            before = log.now()
            t0 = time.perf_counter()
            o = prefill(params, {"tokens": b})
            _sync(dev)
            times.append(time.perf_counter() - t0)
            log.expect(f"{tag} prefill", before, exit_gate=n_exits, qk_norm_rope=k5_all)
            with torch.no_grad():
                again = registry.forward_prefill(params, cfg, {"tokens": b})
            hold(o["exit_confidence"], o["exit_prediction"],
                 [z[:, 0] for z in again["exit_logits"]], plan, f"{tag} prefill")
            before = log.now()
            ot = prefill_t(params, {"tokens": b})
            log.expect(f"{tag} prefill, temperatures=", before, exit_gate=n_exits,
                       qk_norm_rope=k5_all)
            gaps["plan_vs_temps"] = max(gaps["plan_vs_temps"], float(
                (ot["exit_confidence"] - o["exit_confidence"]).abs().max()))
            assert torch.equal(ot["exit_prediction"], o["exit_prediction"])
            assert tuple(o["logits"].shape) == (b.shape[0], 1, cfg.vocab_size)
            assert torch.isfinite(o["logits"].float()).all()
            del o, ot, again
        ms = 1e3 * float(np.median(times))
        out[f"prefill_ms_{tag}"] = ms
        say(f"{tag} plan: prefill {serve[0]} x {serve[1]} tokens {ms:.3f} ms per step (median "
            f"of {[round(1e3 * t, 3) for t in times]}); {mem()}", timed=True)

        serve_step = make_serve_step(cfg, plan=plan, device=dev)
        caches = registry.init_cache(cfg, serve[0], decode, device=dev)
        twin = registry.init_cache(cfg, serve[0], decode, device=dev)
        tok = batches[0][:, :1]
        times = []
        for t in range(decode):
            before = log.now()
            t0 = time.perf_counter()
            o, caches = serve_step(params, tok, caches, t)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            log.expect(f"{tag} decode", before, exit_gate=n_exits, qk_norm_rope=k5_all)
            with torch.no_grad():
                d, twin = registry.decode_step(params, cfg, tok, twin, t)
            assert torch.equal(d["logits"][:, 0], o["logits"]), "two decodes differ"
            hold(o["exit_confidence"], o["exit_prediction"], [z[:, 0] for z in d["exit_logits"]],
                 plan, f"{tag} decode step {t}")
            tok = o["token"][:, None]
        ms = 1e3 * float(np.median(times))
        out[f"decode_ms_{tag}"] = ms
        say(f"{tag} plan: {decode} decode steps at batch {serve[0]}: {ms:.3f} ms per token "
            f"(median; the first {1e3 * times[0]:.3f} ms); {mem()}", timed=True)
        del caches, twin
    say(f"gates: K1 conf against the plain gate max rel {gaps['conf_rel']:.3g} abs "
        f"{gaps['conf_abs']:.3g} (held to rel 2e-5, abs 1e-6); predictions equal on "
        f"{gaps['clear']} of {gaps['rows']} exit rows clear of a tie; the plan path against "
        f"temperatures=: largest conf gap {gaps['plan_vs_temps']:.3g}, predictions equal")
    out["gaps"] = gaps
    if card:
        out["profile"] = lm_profile(dev, cfg, params, plan_c, batches[0], decode, log, say)

    # ---- lm_engine at codec levels 0, 1 and 2: the edge runs the layers up
    # to exit 0, the cloud the rest on the refused rows' (m, s, d) hidden
    s, d = serve[1], cfg.d_model
    row_bytes = {0: s * d * params["embed"]["w"].element_size(),
                 1: scaled_payload_nbytes(s * d * 4, 1), 2: scaled_payload_nbytes(s * d * 4, 2)}
    decisions = {}
    for level in (0, 1, 2):
        eng = lm_engine(params, cfg, plan_c.with_compression(level), device=dev)
        clouds = []
        cloud_fn = eng.cloud_fn
        eng.cloud_fn = lambda h, f=cloud_fn: clouds.append(f(h)) or clouds[-1]
        eng.infer({"tokens": batches[0]})  # warm-up
        eng.stats = EngineStats()
        ons, mixed = [], []
        for b in batches:
            before = log.now()
            res = eng.infer({"tokens": b})
            m = int((~res["on_device"]).sum())
            log.expect(f"lm_engine level {level}", before, exit_gate=1,
                       encode=int(level != 0 and m > 0), decode=int(level != 0 and m > 0),
                       qk_norm_rope=k5_edge if m == 0 else k5_all)
            assert np.isfinite(res["confidence"]).all() and res["prediction"].shape == (len(b),)
            ons.append(res["on_device"])
            if level == 0 and m:
                with torch.no_grad():
                    full = registry.forward_prefill(params, cfg, {"tokens": b})["logits"][:, 0]
                refused = torch.as_tensor(np.flatnonzero(~res["on_device"]), device=dev)
                mixed.append(float((clouds[-1]["logits"].float()
                                    - full[refused].float()).abs().max()))
        st = eng.stats
        decisions[level] = np.concatenate(ons)
        assert st.payload_bytes == st.offloaded * row_bytes[level], (st.payload_bytes, level)
        row = dict(offload_rate=st.offload_rate, payload_bytes=st.payload_bytes,
                   edge_ms=1e3 * st.edge_time_s / max(st.edge_calls, 1),
                   cloud_ms=1e3 * st.cloud_time_s / max(st.cloud_calls, 1))
        out[f"engine_level{level}"] = row
        msg = (f"lm_engine level {level}: offload_rate {st.offload_rate:.4f} of {st.requests} "
               f"sequences, payload_bytes {st.payload_bytes} ({row_bytes[level]} a refused "
               f"row), edge {row['edge_ms']:.3f} ms a batch, cloud {row['cloud_ms']:.3f} ms a "
               f"refused batch ({st.offloaded} rows in {st.cloud_calls})")
        if level == 0:
            # every row refused (p_tar above 1): the cloud's logits are the
            # whole model's last position, bit for bit
            eng.plan = eng.plan.with_p_tar(2.0)
            before = log.now()
            res = eng.infer({"tokens": batches[0]})
            log.expect("lm_engine level 0, all refused", before, exit_gate=1,
                       qk_norm_rope=k5_all)
            assert not res["on_device"].any()
            with torch.no_grad():
                full = registry.forward_prefill(params, cfg, {"tokens": batches[0]})["logits"]
            assert torch.equal(clouds[-1]["logits"], full[:, 0]), \
                "the refused rows' cloud logits differ from forward_prefill's last position"
            msg += ("; all refused: the cloud's logits equal forward_prefill's bit for bit; "
                    f"mixed batches (cloud at m < b rows): max |gap| "
                    f"{max(mixed) if mixed else float('nan'):.3g}")
        say(msg, timed=True)
        del eng, clouds
    # the gate runs before the codec, so the level cannot move who offloads
    assert np.array_equal(decisions[0], decisions[1]) and np.array_equal(decisions[0],
                                                                        decisions[2])
    assert 0 < (~decisions[0]).sum() < len(decisions[0]), decisions[0]
    if card:
        # the benchmark's two shapes: 8 x 512 and 64 x 64 tokens
        short = torch.randint(0, cfg.vocab_size, (64, 64), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(5))
        qk_rope_sync_check(dev, cfg, params, [batches[0], short], say=say)
        del short
    del params, batches
    if card:
        torch.cuda.empty_cache()

    # ---- float32 at full width, 4 layers: decode step by step against
    # forward_train, in both decode modes
    cfg4 = cfg.replace(num_layers=4, exit_layers=(0, 1), dtype="float32")
    p4 = registry.init_params(torch.Generator(device=dev).manual_seed(2), cfg4, device=dev)
    toks = torch.as_tensor(next(iter(TokenIterator(stream, eq[0], eq[1], seed=2)))["tokens"],
                           device=dev)
    errs = {}
    with torch.no_grad():
        full = registry.forward_train(p4, cfg4, {"tokens": toks})
        for unroll in (False, True):
            c4 = cfg4.replace(decode_unroll=unroll)
            caches = registry.init_cache(c4, eq[0], eq[1], device=dev)
            steps = [registry.decode_step(p4, c4, toks[:, t:t + 1], caches, t)[0]
                     for t in range(eq[1])]
            pairs = [("logits", torch.cat([o["logits"] for o in steps], 1), full["logits"])]
            pairs += [(f"exit {i}", torch.cat([o["exit_logits"][i] for o in steps], 1),
                       full["exit_logits"][i]) for i in range(2)]
            for key, got, want in pairs:
                torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
                errs[f"{key} unroll={unroll}"] = float((got - want).abs().max())
    say(f"float32, 4 layers, exits (0, 1), {eq[0]} x {eq[1]}: decode step by step equals "
        f"forward_train (rtol 2e-4, atol 2e-4), max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    out["eq_err"] = max(errs.values())

    # ---- `dev` against the port on the CPU, the same weights, 2 layers
    cfg2 = cfg4.replace(num_layers=2)
    p2 = dict(p4, segments=p4["segments"][:2])  # [L0, exit 0] [L1, exit 1]
    del p4, full, steps, pairs
    t0 = time.perf_counter()
    cpu_p2 = pytree.tree_map(lambda a: a.cpu(), p2)
    toks = torch.as_tensor(next(iter(TokenIterator(stream, cross[0], cross[1],
                                                   seed=3)))["tokens"])
    with torch.no_grad():
        got = registry.forward_train(p2, cfg2, {"tokens": toks.to(dev)})
        want = registry.forward_train(cpu_p2, cfg2, {"tokens": toks})
    readings = []
    for key, g, w, layers in (("logits", got["logits"], want["logits"], 2),
                              ("exit 0", got["exit_logits"][0], want["exit_logits"][0], 1),
                              ("exit 1", got["exit_logits"][1], want["exit_logits"][1], 2)):
        scale = w.abs().max().item()
        atol = 8 * 2.0 ** -24 * scale * sum(r ** 0.5 for r in lm_reductions(cfg2, layers))
        err = (g.cpu() - w).abs().max().item()
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=atol)
        readings.append(f"{key} max|out| {scale:.6g} max err {err:.6g} atol {atol:.6g}")
    say(f"float32, 2 layers, {cross[0]} x {cross[1]}: {dev.type} against the CPU port on the "
        f"same weights (rtol 1e-4, derived atol; {time.perf_counter() - t0:.2f} s): "
        + "; ".join(readings), timed=True)
    del p2, cpu_p2, got, want
    if card:
        torch.cuda.empty_cache()
    say(f"{len(log.steps)} steps' launches (K1, K3, K4; K5 where given) asserted, e.g. "
        + "; ".join(log.steps[:3] + log.steps[-5:]))
    return out


def grow_caches(cfg, caches, batch, length, dev, mesh=None):
    """Decode caches of `length` slots holding a prefill's caches: the
    attention K/V in the first slots, the mamba state as it is (over
    `mesh`, this rank's part of them)."""
    import torch.utils._pytree as pytree

    from repro_torch.models import registry

    new = registry.init_cache(cfg, batch, length, device=dev, mesh=mesh)
    for path, dst in pytree.tree_flatten_with_path(new)[0]:
        src = caches
        for key in path:
            src = src[key.key if hasattr(key, "key") else key.idx]
        if str(getattr(path[-1], "key", "")) in ("k", "v") and src.shape != dst.shape:
            dst.narrow(-3, 0, src.shape[-3]).copy_(src)
        else:
            dst.copy_(src)
    return new


class MoeTap:
    """Records the aux (load-balance loss, dropped share), the expert
    buffer's rows and the routes (each token's top-k experts, (T, k) on
    the host, as the block's router picks them) of every MoE layer the
    model runs while the tap is open."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe, transformer

        self.saved, self.aux, self.rows, self.routes = transformer.apply_moe, [], [], []

        def tapped(p, cfg, x):
            einsum, seen = moe.einsum, []

            def rows(spec, a, b):
                if spec == "ecd,edf->ecf" and not seen:
                    seen.append(a.shape[1])
                return einsum(spec, a, b)

            moe.einsum = rows
            try:
                y, aux = self.saved(p, cfg, x)
            finally:
                moe.einsum = einsum
            self.aux.append({k: v.detach() for k, v in aux.items()})
            self.rows.append(seen[0])
            with torch.no_grad():  # the block's routing, as `moe.apply_moe` computes it
                logits = x.reshape(-1, x.shape[-1]).to(torch.float32) @ p["router"]
                pad = moe.n_alloc_experts(cfg) - cfg.moe_num_experts
                if pad:
                    logits = torch.cat([logits, logits.new_full((len(logits), pad), -1e30)], -1)
                self.routes.append(torch.topk(torch.softmax(logits, dim=-1), cfg.moe_top_k,
                                              dim=-1)[1].to(torch.int16).cpu().numpy())
            return y, aux

        transformer.apply_moe = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.apply_moe = self.saved

    def summary(self):
        """(mean dropped share, mean aux loss, layer calls), then cleared."""
        import torch

        drop = torch.stack([a["moe_dropped_frac"] for a in self.aux]).mean().item()
        aux = torch.stack([a["moe_aux_loss"] for a in self.aux]).mean().item()
        n = len(self.aux)
        self.aux.clear()
        return drop, aux, n


def train_lm_spec(full=True):
    """Phase 12's configurations and sizes: the published ones (`full`),
    or a small CPU rehearsal of the same steps."""
    from repro_torch.configs import get_config, get_smoke

    if full:
        jamba = get_config("jamba-v0.1-52b").replace(num_layers=8, exit_layers=(3,),
                                                     exit_loss_weights=(1.0,))
        return dict(
            mamba=get_config("mamba2-130m"), steps=200, train=(16, 128), n_tokens=800_000,
            serve=(2, 32, 64), f32=(2, 64),
            olmo=["--arch", "olmo-1b", "--steps", "5", "--batch", "8", "--seq", "512"],
            granite=get_config("granite-moe-3b-a800m"), g_val=(64, 256), g_serve=(8, 512),
            g_decode=32, g_train=(4, 512), g_engine=3,
            jamba=jamba, j_serve=(2, 512), j_decode=8, j_f32=(2, 16),
            whisper=["--arch", "whisper-base", "--steps", "3", "--batch", "8", "--seq", "128"],
            w_serve=(2, 64), w_decode=8, w_f32=(2, 16))
    small = dict(vocab_size=512)
    return dict(
        mamba=get_smoke("mamba2-130m").replace(num_layers=4, exit_layers=(0, 1),
                                               exit_loss_weights=(1.0, 1.0), **small),
        steps=30, train=(4, 32), n_tokens=20_000, serve=(2, 8, 16), f32=(2, 16),
        olmo=["--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch", "2", "--seq", "32",
              "--device", "cpu"],
        granite=get_smoke("granite-moe-3b-a800m").replace(num_layers=4, exit_layers=(0, 1),
                                                          exit_loss_weights=(1.0, 1.0)),
        g_val=(16, 32), g_serve=(4, 32), g_decode=4, g_train=(2, 32), g_engine=2,
        jamba=get_smoke("jamba-v0.1-52b").replace(num_layers=4, exit_layers=(1,)),
        j_serve=(2, 32), j_decode=4, j_f32=(2, 8),
        whisper=["--arch", "whisper-base", "--smoke", "--steps", "2", "--batch", "2", "--seq",
                 "16", "--device", "cpu"],
        w_serve=(2, 16), w_decode=4, w_f32=(2, 8))


def train_lm_phase(dev, spec, ckpt_dir, say=print):
    """LM training and the rest of the zoo on `dev` (`spec` from
    `train_lm_spec`): a. mamba2-130m trained as examples/train_lm.py
    trains it, its exits calibrated (plain fit and K2) and served through
    the gate, and a float32 train step on `dev` against the CPU; b.
    olmo-1b through launch.train.main with a checkpoint reloaded bit for
    bit; c. granite-moe served, trained one step and run through
    lm_engine; d. jamba cut to one 8-layer period served, with a float32
    decode check; e. whisper-base trained through the launcher and
    served with its cross caches, with a float32 decode check. Returns
    the printed numbers."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.calibration import fit_temperature, nll
    from repro_torch.core.policy import make_plan
    from repro_torch.data.pipeline import TokenIterator
    from repro_torch.data.synthetic import lm_sequences
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.compress import scaled_payload_nbytes
    from repro_torch.launch import train
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import registry, transformer, whisper
    from repro_torch.offload.engine import EngineStats, lm_engine
    from repro_torch.training import checkpoint, optim
    from repro_torch.training.loop import loss_fn, make_eval_step, make_train_step

    card = dev.type == "cuda"
    log = LaunchLog(dev)
    out = {}
    u32 = 2.0 ** -24

    def mem(peak_only=False):
        if not card:
            return "memory not measured (CPU)"
        peak = f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB"
        return peak if peak_only else (f"{torch.cuda.memory_allocated() / 1e9:.3f} GB "
                                       f"allocated, {peak}")

    def reset_peak():
        _sync(dev)
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if card else float("nan")

    def seeded(cfg, seed=0):
        return registry.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                    device=dev)

    def grads_of(params, cfg, batch):
        leaves, spec_ = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = loss_fn(pytree.tree_unflatten(leaves, spec_), cfg, batch, False)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def busy(fn, n, what):
        """The device's share of `n` calls of fn under torch.profiler:
        kernel ms and launches a call against the host ms a call, and the
        top kernels (card only)."""
        if not card:
            return None
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        _sync(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            _sync(dev)
        host = 1e3 * (time.perf_counter() - t0) / n
        kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        ms = sum(e.self_device_time_total for e in kern) / (1e3 * n)
        launches = sum(e.count for e in kern) / n
        say(f"profiled {what}: {ms:.3f} ms of kernels in {launches:.0f} launches a call against "
            f"{host:.3f} ms a call under the profiler ({1 - ms / host:.1%} idle); top: "
            + "; ".join(f"{e.key[:40]} {e.self_device_time_total / (1e3 * n):.3f} ms "
                        f"x{e.count // n}" for e in kern[:5]), timed=True)
        return dict(kernel_ms=ms, launches=launches, host_ms=host)

    def decode_tokens(cfg, params, serve_step, tok, caches, start, n, n_exits, tag):
        """n serve steps from position `start`; K1 launches asserted."""
        times, confs = [], []
        for t in range(start, start + n):
            before = log.now()
            t0 = time.perf_counter()
            o, caches = serve_step(params, tok, caches, t)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            log.expect(tag, before, exit_gate=n_exits)
            assert torch.isfinite(o["logits"].float()).all(), tag
            confs.append(o["exit_confidence"])
            tok = o["token"][:, None]
        return 1e3 * float(np.median(times)), torch.stack(confs), caches

    # ---------------------------------------------------------------- a
    cfg = spec["mamba"]
    V, n_exits = cfg.vocab_size, len(cfg.exit_layers)
    t0 = time.perf_counter()
    stream = lm_sequences(spec["n_tokens"], V, seed=0, order=1, branch=4)
    it = iter(TokenIterator(stream, *spec["train"]))
    t_data = time.perf_counter() - t0
    reset_peak()
    params = seeded(cfg)
    n = transformer.num_params(params)
    steps = spec["steps"]
    step = make_train_step(cfg, optim.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=20),
                           remat=False, device=dev)
    state = optim.init(params)
    say(f"a. {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, state {cfg.ssm_state}, vocab "
        f"{V}, exits after {cfg.exit_layers}; {n} scalars (param_count {cfg.param_count()}); "
        f"lm_sequences({spec['n_tokens']}, order=1, branch=4) in {t_data:.2f} s (numpy); "
        f"{mem()}", timed=True)
    hist, times = [], []
    for i in range(steps):
        b = next(it)
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        hist.append(torch.stack([m["loss_final"]] + [m[f"loss_exit{j}"] for j in range(n_exits)]))
        if i % 25 == 0 or i == steps - 1:
            h = hist[-1].tolist()
            say(f"step {i:4d} final={h[0]:.3f} " + " ".join(
                f"exit{j}={h[1 + j]:.3f}" for j in range(n_exits)))
    hist = torch.stack(hist).float().cpu().numpy()
    assert np.isfinite(hist).all(), "a training loss is not finite"
    assert (hist[-1] < hist[0]).all() and (hist[-1] < np.log(V)).all(), (hist[0], hist[-1])
    ms = 1e3 * float(np.median(times[1:]))
    say(f"{steps} AdamW steps at {spec['train'][0]} x {spec['train'][1]}, remat off: "
        f"{ms:.3f} ms per step (median; the first {1e3 * times[0]:.1f} ms); loss (final, exits) "
        f"{np.round(hist[0], 4).tolist()} -> {np.round(hist[-1], 4).tolist()} against log V "
        f"{np.log(V):.4f}; {mem()}", timed=True)
    out["mamba"] = dict(step_ms=ms, first=hist[0].tolist(), last=hist[-1].tolist())
    pb = next(it)
    out["mamba"]["profile"] = busy(lambda: step(params, state, pb), 2,
                                   "train step (functional: results dropped)")
    del state, step

    held = next(it)
    ev = make_eval_step(cfg, device=dev)(params, held)
    y = torch.as_tensor(held["labels"], device=dev).reshape(-1).to(torch.int64)
    temps, fits = [], []
    for j, ex in enumerate(ev["exit_logits"]):
        z = ex.reshape(-1, V)
        t0 = time.perf_counter()
        tp, info = fit_temperature(z.float(), y)
        _sync(dev)
        t_plain = time.perf_counter() - t0
        # Newton in T leaves for t_max from where the NLL is concave in T
        # (below an optimum T* < 1 from T = 1): K2 starts from the best
        # point of a log grid whose NLLs K2 computes
        t0 = time.perf_counter()
        start = min(K2_GRID, key=lambda t: float(ops.calib_stats(z, y, t)[0]))
        tk, _ = ops.fit_temperature_kernel(z, y, t0=start)
        _sync(dev)
        t_k2 = time.perf_counter() - t0
        tp, tk = float(tp), float(tk)
        n_p, n_k = float(nll(z.float(), y, tp)), float(nll(z.float(), y, tk))
        assert abs(tk - tp) <= 1e-3 * tp or abs(n_k - n_p) <= 1e-6 * abs(n_p), (j, tk, tp)
        temps.append(tp)
        fits.append((tp, tk, n_p, n_k))
        say(f"exit {j}: logits {tuple(z.shape)} {str(z.dtype)[6:]}; plain fit T {tp:.6f} "
            f"(NLL {float(info['nll_before']):.4f} -> {n_p:.6f}) in {t_plain:.3f} s; K2 fit T "
            f"{tk:.6f} (NLL {n_k:.6f}; Newton from {start}) in {t_k2:.3f} s", timed=True)
    out["fits"] = fits
    b2, n_tok, cache_len = spec["serve"]
    serve = make_serve_step(cfg, temperatures=temps, device=dev)
    caches = registry.init_cache(cfg, b2, cache_len, device=dev)
    tok = torch.as_tensor(held["tokens"][:b2, :1], device=dev)
    ms, confs, _ = decode_tokens(cfg, params, serve, tok, caches, 0, n_tok, n_exits, "a. serve")
    cleared = int((confs.max(1).values > 0.8).sum())
    say(f"served {n_tok} tokens x {b2} seqs from init_cache({b2}, {cache_len}): {ms:.3f} ms a "
        f"token (median); {cleared}/{n_tok * b2} token-steps cleared the calibrated "
        f"0.8-confidence gate at an early exit; {n_exits} K1 launches a step asserted",
        timed=True)
    out["serve"] = dict(token_ms=ms, cleared=cleared)
    del params, ev, caches

    # float32, 2 layers: one train step's loss and gradients on `dev`
    # against the CPU port on the same weights and batch
    cfg2 = cfg.replace(num_layers=2, exit_layers=(0,), exit_loss_weights=(1.0,),
                       dtype="float32")
    p2 = seeded(cfg2, seed=3)
    fb = next(iter(TokenIterator(stream, *spec["f32"], seed=3)))
    fl, fg = grads_of(p2, cfg2, {k: torch.as_tensor(v, device=dev) for k, v in fb.items()})
    cl, cg = grads_of(pytree.tree_map(lambda a: a.cpu(), p2), cfg2,
                      {k: torch.as_tensor(v) for k, v in fb.items()})
    red = lm_reductions(cfg2, 2, seq=spec["f32"][1])
    chain = 2 * sum(r ** 0.5 for r in red) + (fb["tokens"].size ** 0.5)
    worst = 0.0
    for g, w in zip(fg, cg):
        atol = 8 * u32 * float(w.abs().max()) * chain
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=atol)
        worst = max(worst, float((g.cpu() - w).abs().max()) / max(atol, 1e-30))
    assert abs(float(fl) - float(cl)) <= 1e-4 * abs(float(cl)), (float(fl), float(cl))
    say(f"float32, 2 layers, {spec['f32'][0]} x {spec['f32'][1]}: loss {float(fl):.7f} on "
        f"{dev.type} against {float(cl):.7f} on the CPU; {len(fg)} gradient leaves within rtol "
        f"1e-4 and the derived atol 8 u max|g| (2 sum sqrt(r) + sqrt(b s)), the largest gap "
        f"{worst:.3g} of its atol")
    out["f32_worst"] = worst
    del p2, fg, cg
    reset_peak()

    # ---------------------------------------------------------------- b
    path = os.path.join(ckpt_dir, "olmo.msgpack")
    t0 = time.perf_counter()
    run = train.main(spec["olmo"] + ["--ckpt", path, "--log-every", "1"])
    wall = time.perf_counter() - t0
    params = run["params"]
    peak_remat = peak_gb()
    ms = 1e3 * float(np.median(run["step_s"][1:]))
    say(f"b. launch.train {' '.join(spec['olmo'])}: {transformer.num_params(params)} scalars; "
        f"{ms:.3f} ms per step (median; the first {1e3 * run['step_s'][0]:.1f} ms) with remat; "
        f"{wall:.2f} s in all; {mem()}", timed=True)
    t0 = time.perf_counter()
    back = checkpoint.load(path, {"params": params, "step": torch.tensor(0, dtype=torch.int32)})
    t_load = time.perf_counter() - t0
    pairs = list(zip(pytree.tree_leaves(back["params"]), pytree.tree_leaves(params)))
    assert all(a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                                                  else a, b.view(torch.int16)
                                                  if b.dtype == torch.bfloat16 else b)
               for a, b in pairs), "the checkpoint does not reload bit for bit"
    assert int(back["step"]) == int(spec["olmo"][spec["olmo"].index("--steps") + 1])
    say(f"checkpoint {os.path.getsize(path)} bytes reloaded in {t_load:.2f} s: {len(pairs)} "
        f"leaves equal bit for bit", timed=True)
    del back, pairs
    os.remove(path)
    ocfg = (get_smoke if "--smoke" in spec["olmo"] else get_config)(
        spec["olmo"][spec["olmo"].index("--arch") + 1])
    seq_b = (int(spec["olmo"][spec["olmo"].index("--batch") + 1]),
             int(spec["olmo"][spec["olmo"].index("--seq") + 1]))
    ostate = optim.init(params)
    reset_peak()
    ostep = make_train_step(ocfg, optim.AdamWConfig(), remat=False, device=dev, inplace=True)
    ob = next(iter(TokenIterator(lm_sequences(50_000, ocfg.vocab_size, seed=5), *seq_b)))
    t0 = time.perf_counter()
    params, ostate, om = ostep(params, ostate, ob)
    _sync(dev)
    say(f"one step without remat at {seq_b[0]} x {seq_b[1]}: {1e3 * (time.perf_counter() - t0):.1f}"
        f" ms (the step's first call), loss {float(om['loss']):.4f}; {mem(True)} against "
        f"{peak_remat:.3f} GB with remat over launch.train's run", timed=True)
    out["olmo"] = dict(step_ms=ms, peak_remat=peak_remat, peak_plain=peak_gb())
    del params, ostate, run, ostep, om
    reset_peak()

    # ---------------------------------------------------------------- c
    cfg = spec["granite"]
    n_exits = len(cfg.exit_layers)
    k5_all = k5_launches(cfg, 0, cfg.num_layers)
    k5_edge = k5_launches(cfg, 0, cfg.exit_layers[0] + 1)
    t0 = time.perf_counter()
    params = seeded(cfg)
    _sync(dev)
    say(f"c. {cfg.name}: {cfg.num_layers} layers, {cfg.moe_num_experts} experts top-"
        f"{cfg.moe_top_k}, segments {[(g[1], g[2]) for g in transformer.segment_plan(cfg)]}; "
        f"{transformer.num_params(params)} scalars (param_count {cfg.param_count()}) in "
        f"{time.perf_counter() - t0:.2f} s; {mem()}", timed=True)
    gstream = lm_sequences(max(100_000, 4 * spec["g_val"][0] * spec["g_val"][1]), cfg.vocab_size,
                           seed=0)
    vb = next(iter(TokenIterator(gstream, *spec["g_val"], seed=0)))
    sb = iter(TokenIterator(gstream, *spec["g_serve"], seed=1))
    batches = [torch.as_tensor(next(sb)["tokens"], device=dev) for _ in range(spec["g_engine"])]
    prefill = make_prefill_step(cfg, device=dev)
    serve = make_serve_step(cfg, device=dev)
    with MoeTap() as tap, torch.no_grad():
        before = log.now()
        prefill(params, {"tokens": batches[0]})  # warm-up
        _sync(dev)
        log.expect("c. prefill warm-up", before, exit_gate=n_exits, qk_norm_rope=k5_all)
        tap.summary()
        before = log.now()
        t0 = time.perf_counter()
        o = prefill(params, {"tokens": batches[1]})
        _sync(dev)
        pre_ms = 1e3 * (time.perf_counter() - t0)
        log.expect("c. prefill", before, exit_gate=n_exits, qk_norm_rope=k5_all)
        drop, aux, calls = tap.summary()
        bsz, seq = spec["g_serve"]
        caches = grow_caches(cfg, o["caches"], bsz, seq + spec["g_decode"], dev)
        dec_ms, _, _ = decode_tokens(cfg, params, serve, o["logits"][:, 0].argmax(-1)[:, None],
                                     caches, seq, spec["g_decode"], n_exits, "c. decode")
        ddrop, daux, dcalls = tap.summary()
        last = seq + spec["g_decode"] - 1  # rewrites the last decoded slot
        before = log.now()
        prof_pre = busy(lambda: prefill(params, {"tokens": batches[1]}), 1, "granite prefill")
        prof_dec = busy(lambda: serve(params, batches[1][:, :1], caches, last), 2,
                        "granite decode step")
        log.expect("c. profiled prefill and decode", before, exit_gate=3 * n_exits,
                   qk_norm_rope=3 * k5_all)
        tap.aux.clear()
    say(f"prefill {bsz} x {seq}: {pre_ms:.3f} ms; MoE over its {calls} layers: dropped share "
        f"{drop:.6f}, aux loss {aux:.6f} (means); {spec['g_decode']} decode steps from the "
        f"prefill's caches (positions {seq}-{seq + spec['g_decode'] - 1}): {dec_ms:.3f} ms a "
        f"token (median), dropped share {ddrop:.6f}, aux loss {daux:.6f}; {mem()}", timed=True)
    out["granite"] = dict(prefill_ms=pre_ms, decode_ms=dec_ms, dropped=drop, aux=aux,
                          profile=(prof_pre, prof_dec))
    del o, caches
    # validation logits for the engine's plan, on the seeded weights
    zs, chunk = [[] for _ in range(n_exits)], max(1, spec["g_val"][0] // 4)
    with torch.no_grad():
        for i in range(0, spec["g_val"][0], chunk):
            o = registry.forward_prefill(params, cfg, {"tokens": torch.as_tensor(
                vb["tokens"][i:i + chunk], device=dev)})
            for j in range(n_exits):
                zs[j].append(o["exit_logits"][j][:, 0])
    zs = [torch.cat(z) for z in zs]
    yv = torch.as_tensor(vb["labels"][:, -1], device=dev)
    del o
    # one train step with remat, updating in place
    reset_peak()
    gstate = optim.init(params)
    gstep = make_train_step(cfg, optim.AdamWConfig(), remat=True, device=dev, inplace=True)
    tb = next(iter(TokenIterator(gstream, *spec["g_train"], seed=2)))
    t0 = time.perf_counter()
    params, gstate, gm = gstep(params, gstate, tb)
    _sync(dev)
    g_ms = 1e3 * (time.perf_counter() - t0)
    assert all(torch.isfinite(v) for v in gm.values())
    say(f"one train step at {spec['g_train'][0]} x {spec['g_train'][1]}, remat, in place: "
        f"{g_ms:.1f} ms (the step's first call), loss {float(gm['loss']):.4f} (aux "
        f"{float(gm['moe_aux']):.4f}), grad norm {float(gm['grad_norm']):.4f}; {mem()}",
        timed=True)
    out["granite"].update(train_ms=g_ms, train_peak=peak_gb())
    del gstate, gstep
    reset_peak()
    plan = make_plan(zs, yv, p_tar=0.5, calibrated=False)
    c = torch.sort(ref.exit_gate_ref(zs[0], 1.0)[0].double())[0]
    plan = plan.with_p_tar(float((c[len(c) // 2 - 1] + c[len(c) // 2]) / 2))
    del zs
    s_, d_ = spec["g_serve"][1], cfg.d_model
    row_bytes = {0: s_ * d_ * 2, 1: scaled_payload_nbytes(s_ * d_ * 4, 1),
                 2: scaled_payload_nbytes(s_ * d_ * 4, 2)}
    decisions = {}
    for level in (0, 1, 2):
        eng = lm_engine(params, cfg, plan.with_compression(level), device=dev)
        eng.infer({"tokens": batches[0]})  # warm-up
        eng.stats = EngineStats()
        ons = []
        for b in batches:
            before = log.now()
            res = eng.infer({"tokens": b})
            m = int((~res["on_device"]).sum())
            log.expect(f"c. lm_engine level {level}", before, exit_gate=1,
                       encode=int(level != 0 and m > 0), decode=int(level != 0 and m > 0),
                       qk_norm_rope=k5_edge if m == 0 else k5_all)
            assert np.isfinite(res["confidence"]).all()
            ons.append(res["on_device"])
        st = eng.stats
        decisions[level] = np.concatenate(ons)
        assert st.payload_bytes == st.offloaded * row_bytes[level], (st.payload_bytes, level)
        row = dict(offload_rate=st.offload_rate, payload_bytes=st.payload_bytes,
                   edge_ms=1e3 * st.edge_time_s / max(st.edge_calls, 1),
                   cloud_ms=1e3 * st.cloud_time_s / max(st.cloud_calls, 1))
        out[f"granite_engine{level}"] = row
        say(f"lm_engine level {level}: offload_rate {st.offload_rate:.4f} of {st.requests}, "
            f"payload_bytes {st.payload_bytes} ({row_bytes[level]} a refused row), edge "
            f"{row['edge_ms']:.3f} ms a batch, cloud {row['cloud_ms']:.3f} ms a refused batch",
            timed=True)
        del eng
    assert all(np.array_equal(decisions[0], decisions[k]) for k in (1, 2))
    del params, batches
    reset_peak()

    # ---------------------------------------------------------------- d
    cfg = spec["jamba"]
    n_exits = len(cfg.exit_layers)
    t0 = time.perf_counter()
    params = seeded(cfg)
    _sync(dev)
    say(f"d. {cfg.name} cut to {cfg.num_layers} layers (kinds {cfg.layer_plan()}; exits "
        f"{cfg.exit_layers}): {transformer.num_params(params)} scalars in "
        f"{time.perf_counter() - t0:.2f} s; {mem()}", timed=True)
    bsz, seq = spec["j_serve"]
    toks = torch.as_tensor(next(iter(TokenIterator(
        lm_sequences(50_000, cfg.vocab_size, seed=4), bsz, seq)))["tokens"], device=dev)
    with MoeTap() as tap:
        before = log.now()
        t0 = time.perf_counter()
        o = make_prefill_step(cfg, device=dev)(params, {"tokens": toks})
        _sync(dev)
        pre_ms = 1e3 * (time.perf_counter() - t0)
        log.expect("d. prefill", before, exit_gate=n_exits, qk_norm_rope=0)  # no RoPE
        drop, aux, calls = tap.summary()
        caches = grow_caches(cfg, o["caches"], bsz, seq + spec["j_decode"], dev)
        dec_ms, _, _ = decode_tokens(cfg, params, make_serve_step(cfg, device=dev),
                                     o["logits"][:, 0].argmax(-1)[:, None], caches, seq,
                                     spec["j_decode"], n_exits, "d. decode")
    say(f"prefill {bsz} x {seq}: {pre_ms:.3f} ms (the step's first call); MoE over {calls} "
        f"layers: dropped share {drop:.6f}, aux loss {aux:.6f}; {spec['j_decode']} decode steps "
        f"from its caches: {dec_ms:.3f} ms a token; {mem()}", timed=True)
    out["jamba"] = dict(prefill_ms=pre_ms, decode_ms=dec_ms)
    del params, o, caches
    reset_peak()
    # float32, 2 layers ((mamba, dense), (mamba, moe)): decode token by
    # token against forward_train, capacity enough that neither drops
    cfgj = cfg.replace(num_layers=2, exit_layers=(0,), dtype="float32", moe_capacity_factor=8.0)
    pj = seeded(cfgj, seed=6)
    fb = torch.as_tensor(next(iter(TokenIterator(lm_sequences(20_000, cfg.vocab_size, seed=6),
                                                 *spec["j_f32"])))["tokens"], device=dev)
    errs = {}
    with torch.no_grad():
        full = registry.forward_train(pj, cfgj, {"tokens": fb}, remat=False)
        caches = registry.init_cache(cfgj, fb.shape[0], fb.shape[1], device=dev)
        steps_ = [registry.decode_step(pj, cfgj, fb[:, t:t + 1], caches, t)[0]
                  for t in range(fb.shape[1])]
    for key, got, want in (("logits", torch.cat([s["logits"] for s in steps_], 1), full["logits"]),
                           ("exit 0", torch.cat([s["exit_logits"][0] for s in steps_], 1),
                            full["exit_logits"][0])):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        errs[key] = float((got - want).abs().max())
    say(f"float32, 2 layers, {spec['j_f32'][0]} x {spec['j_f32'][1]}: decode step by step equals "
        f"forward_train (rtol 2e-4, atol 2e-4), max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    out["jamba"]["f32_err"] = max(errs.values())
    del pj, full, steps_, caches
    reset_peak()

    # ---------------------------------------------------------------- e
    t0 = time.perf_counter()
    run = train.main(spec["whisper"] + ["--log-every", "1"])
    params = run["params"]
    wcfg = (get_smoke if "--smoke" in spec["whisper"] else get_config)("whisper-base")
    n_exits = len(wcfg.exit_layers)
    ms = 1e3 * float(np.median(run["step_s"][1:]))
    say(f"e. launch.train {' '.join(spec['whisper'])}: {ms:.3f} ms per step (median; the first "
        f"{1e3 * run['step_s'][0]:.1f} ms), {time.perf_counter() - t0:.2f} s in all; {mem()}",
        timed=True)
    bsz, seq = spec["w_serve"]
    frames = torch.zeros((bsz, wcfg.encoder_seq, wcfg.d_model), dtype=torch.bfloat16, device=dev)
    toks = torch.as_tensor(next(iter(TokenIterator(lm_sequences(50_000, wcfg.vocab_size, seed=7),
                                                   bsz, seq)))["tokens"], device=dev)
    before = log.now()
    t0 = time.perf_counter()
    o = make_prefill_step(wcfg, device=dev)(params, {"tokens": toks, "encoder_frames": frames})
    _sync(dev)
    pre_ms = 1e3 * (time.perf_counter() - t0)
    log.expect("e. prefill", before, exit_gate=n_exits, qk_norm_rope=0)  # no RoPE
    caches = grow_caches(wcfg, o["caches"], bsz, seq + spec["w_decode"], dev)
    dec_ms, _, _ = decode_tokens(wcfg, params, make_serve_step(wcfg, device=dev),
                                 o["logits"][:, 0].argmax(-1)[:, None], caches, seq,
                                 spec["w_decode"], n_exits, "e. decode")
    say(f"prefill {bsz} x {seq} with the (b, {wcfg.encoder_seq}, {wcfg.d_model}) frames: "
        f"{pre_ms:.3f} ms (the step's first call); {spec['w_decode']} decode steps with the "
        f"cross caches: {dec_ms:.3f} ms a token", timed=True)
    out["whisper"] = dict(step_ms=ms, prefill_ms=pre_ms, decode_ms=dec_ms)
    del params, run, o, caches
    # float32 at full width: decode with prefill_cross_caches against
    # forward_train on random frames
    cfgw = wcfg.replace(dtype="float32")
    pw = seeded(cfgw, seed=8)
    gen = torch.Generator(device=dev).manual_seed(9)
    wb, ws = spec["w_f32"]
    fr = torch.randn((wb, cfgw.encoder_seq, cfgw.d_model), generator=gen, device=dev)
    tk = torch.randint(0, cfgw.vocab_size, (wb, ws), generator=gen, device=dev)
    with torch.no_grad():
        full = registry.forward_train(pw, cfgw, {"tokens": tk, "encoder_frames": fr}, remat=False)
        wc = whisper.init_cache(cfgw, wb, ws, device=dev)
        wc["cross"] = whisper.prefill_cross_caches(pw, cfgw, fr)
        steps_ = [whisper.decode_step(pw, cfgw, tk[:, t:t + 1], wc, t)[0] for t in range(ws)]
    errs = {}
    for key, got, want in (("logits", torch.cat([s["logits"] for s in steps_], 1), full["logits"]),
                           ("exit 0", torch.cat([s["exit_logits"][0] for s in steps_], 1),
                            full["exit_logits"][0])):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        errs[key] = float((got - want).abs().max())
    say(f"float32, full width, {wb} x {ws}: decode with prefill_cross_caches equals "
        f"forward_train (rtol 2e-4, atol 2e-4), max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    out["whisper"]["f32_err"] = max(errs.values())
    del pw, full, steps_, wc
    reset_peak()
    say(f"{len(log.steps)} steps' launches (K1, K3, K4; K5 where given) asserted, e.g. "
        + "; ".join(log.steps[:2] + log.steps[-3:]))
    return out


# the dry run's pairs on the card: every arch at prefill_32k and qwen3-8b
# at its other three shapes, longest traces first (they run in parallel)
DRYRUN_PAIRS = ([(a, "prefill_32k") for a in ("qwen2-72b", "internlm2-20b", "qwen3-moe-30b-a3b",
                                              "chameleon-34b", "qwen3-8b", "granite-moe-3b-a800m",
                                              "jamba-v0.1-52b", "olmo-1b", "mamba2-130m",
                                              "whisper-base")]
                + [("qwen3-8b", s) for s in ("train_4k", "decode_32k", "long_500k")])


def dryrun_worker(job):
    """Trace one dry-run pair, job = (arch, shape, device type), on fake
    tensors in a process of its own: returns the record, the bytes the
    trace left allocated on the card and the kernels it launched (both
    must be 0)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import calib_nll, compress, exit_gate, qk_rope
    from repro_torch.launch import dryrun

    arch, shape, device = job
    kernels = (exit_gate.KERNEL, calib_nll.KERNEL, compress.ENCODE, compress.DECODE,
               qk_rope.KERNEL)
    cuda = device == "cuda"
    before = torch.cuda.memory_allocated() if cuda else 0
    rec = dryrun.run_one(arch, shape, outdir=None, device=device)
    if cuda:
        torch.cuda.synchronize()
    after = torch.cuda.memory_allocated() if cuda else 0
    return rec, after - before, sum(k.launches for k in kernels)


def step_cross_check(dev, name, cfg, shape, remat, reps=3, say=print):
    """The dry run's FLOPs and peak bytes for one step against the same
    step run for real on `dev` (seeded params, random tokens): median ms
    of `reps` calls after a warm-up (host clock to a sync), achieved
    TFLOP/s, and the allocator's peak over those calls."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun, hlo_cost
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import registry
    from repro_torch.training import optim
    from repro_torch.training.loop import make_train_step

    t0 = time.perf_counter()
    with FakeTensorMode(allow_fallback_kernels=False):
        step, args, _ = dryrun.build_step(cfg, shape, dev, remat=remat)
        cost = hlo_cost.analyze(step, *args)
    del step, args
    trace_s = time.perf_counter() - t0
    b, s = shape.global_batch, shape.seq_len
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev, dtype=torch.int32)
    if shape.kind == "train":
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev,
                               dtype=torch.int32)
        train = make_train_step(cfg, optim.AdamWConfig(), remat=remat, device=dev, inplace=True)
        state = [params, optim.init(params), {"tokens": tokens, "labels": labels}]

        def call():
            state[0], state[1], m = train(*state)
            return m["loss"]
    else:
        prefill = make_prefill_step(cfg, device=dev)

        def call():
            return prefill(params, {"tokens": tokens})["logits"]
    out = call()
    _sync(dev)
    assert bool(torch.isfinite(out.float()).all()), f"{name}: the step's output is not finite"
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        call()
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t1))
    ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() if cuda else float("nan")
    del out, params, tokens, call
    if shape.kind == "train":
        del state, train
    if cuda:
        torch.cuda.empty_cache()
    tflops = cost["flops"] / (ms * 1e-3) / 1e12
    say(f"{name} ({'remat ' if shape.kind == 'train' and remat else ''}{shape.kind} {b} x {s}): "
        f"dry run {cost['flops']:.4e} FLOPs, {cost['bytes']:.4e} B unfused, peak "
        f"{cost['peak_bytes'] / 1e9:.3f} GB (traced in {trace_s:.2f} s); measured {ms:.3f} ms "
        f"(median of {[round(t, 3) for t in times]}): {tflops:.1f} TFLOP/s, "
        f"{tflops * 1e12 / BF16_FLOP_PER_S:.1%} of the {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 "
        f"dense peak; max_memory_allocated {peak / 1e9:.3f} GB (dry run / measured "
        f"{cost['peak_bytes'] / peak:.3f})", timed=True)
    assert cost["flops"] > 0 and cost["peak_bytes"] > 0
    return dict(flops=cost["flops"], bytes=cost["bytes"], dry_peak=cost["peak_bytes"], ms=ms,
                tflops=tflops, peak=peak)


def dryrun_steps(full=True):
    """(name, config, shape, remat) of the steps phases 11-12 run: at full
    width, or (full=False, to rehearse on the CPU) their smoke configs at
    small shapes."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import ShapeConfig

    get = get_config if full else get_smoke
    b, s, mb, ms = (8, 512, 16, 128) if full else (2, 32, 2, 32)
    return [("qwen3-8b", get("qwen3-8b"), ShapeConfig("prefill", s, b, "prefill"), True),
            ("olmo-1b", get("olmo-1b"), ShapeConfig("train", s, b, "train"), True),
            ("mamba2-130m", get("mamba2-130m"), ShapeConfig("train", ms, mb, "train"), False)]


def dryrun_phase(dev, params, plan, phase5_stats, test_x, pairs=DRYRUN_PAIRS, steps=None,
                 workers=6, say=print):
    """The dry run on `dev`: `pairs` traced on fake tensors in `workers`
    processes (no kernel launched, no byte allocated); the three steps
    phases 11-12 run (`dryrun_steps`), traced and run for real (FLOPs
    against ms, peak bytes against max_memory_allocated); and
    `latency.h100` from the trained B-AlexNet engine's measured stats,
    beside `paper_2020`."""
    import multiprocessing

    import torch

    from repro_torch.offload import latency
    from repro_torch.offload.engine import EngineStats, convnet_engine

    # (a) every arch at prefill_32k and qwen3-8b at all four shapes
    cuda = dev.type == "cuda"
    _sync(dev)
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        results = pool.map(dryrun_worker, [(a, s, dev.type) for a, s in pairs], chunksize=1)
    wall = time.perf_counter() - t0
    assert (torch.cuda.memory_allocated() if cuda else 0) == mem0
    records = []
    for (arch, shape), (rec, alloc, launched) in zip(pairs, results):
        assert alloc == 0 and launched == 0, (arch, shape, alloc, launched)
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["device"] == (torch.cuda.get_device_name(dev) if cuda else "cpu")
        mem = rec["memory"]
        say(f"dry run {arch} {shape}: {rec['flops'] / 1e9:.6g} GFLOPs, "
            f"{rec['bytes_accessed'] / 1e9:.6g} GB unfused; GB params "
            f"{mem['params_bytes'] / 1e9:.3f} opt {mem['opt_state_bytes'] / 1e9:.3f} cache "
            f"{mem['cache_bytes'] / 1e9:.3f} batch {mem['batch_bytes'] / 1e9:.4f} peak "
            f"{mem['peak_bytes'] / 1e9:.3f}; fits one card ({rec['card_bytes'] / 1e9:.2f} GB) "
            f"{rec['fits_one_card']}; traced in {rec['trace_s']} s on {rec['device']}; "
            f"0 kernels, 0 bytes allocated")
        records.append(rec)
    say(f"{len(pairs)} pairs traced on fake {dev.type} tensors in {workers} processes in "
        f"{wall:.1f} s (trace s summed {sum(r['trace_s'] for r in records):.1f})")

    # (b) the steps phases 11-12 run, dry and for real
    cross = {name: step_cross_check(dev, name, cfg, shape, remat, say=say)
             for name, cfg, shape, remat in (steps or dryrun_steps())}

    # (c) the measured H100 profile. Phase 5's stats (branch 2's cloud paid
    # cuDNN's set-up for each new refused-batch size, so its path looks
    # slower than branch 1's longer one) are shown; the profile is built
    # from both branches served warm with every sample offloaded (one
    # batch size, 512), where the nesting of the paths holds.
    for (branch, level), st in sorted(phase5_stats.items()):
        say(f"phase 5 branch {branch} level {level}: edge {1e6 * st.edge_time_s / st.requests:.4f}"
            f" us a sample, cloud {1e6 * st.cloud_time_s / max(st.offloaded, 1):.4f} us an "
            f"offloaded sample", timed=True)
    stats = {}
    for branch in (1, 2):
        engine = convnet_engine(params, plan.with_p_tar(2.0), branch=branch, use_kernel=True,
                                device=dev)
        engine.infer({"images": test_x[:512]})  # warm-up: cuDNN plans the 512-row batch
        engine.stats = EngineStats()
        for i in range(0, len(test_x), 512):
            engine.infer({"images": test_x[i:i + 512]})
        assert engine.stats.offloaded == engine.stats.requests == len(test_x)
        stats[branch] = engine.stats
    h100 = latency.h100(stats, uplink_bps=latency.paper_2020().uplink_bps)
    paper = latency.paper_2020()
    for branch, st in stats.items():
        for got, want in ((latency.edge_time(h100, branch), st.edge_time_s / st.requests),
                          (latency.cloud_time(h100, branch), st.cloud_time_s / st.offloaded)):
            assert abs(got - want) <= 1e-9 * want, (branch, got, want)
    say("h100 profile (us a sample) against paper_2020: "
        + "; ".join(f"{k} edge {1e6 * h100.edge_layer_s[k]:.4f} / {1e6 * paper.edge_layer_s[k]:.2f}"
                    f" cloud {1e6 * h100.cloud_layer_s[k]:.4f} / {1e6 * paper.cloud_layer_s[k]:.2f}"
                    for k in h100.edge_layer_s)
        + "; " + "; ".join(f"{k} {1e6 * v:.4f} / {1e6 * paper.branch_s[k]:.2f}"
                          for k, v in h100.branch_s.items()), timed=True)
    for branch in (1, 2):
        say(f"branch {branch}: edge_time {1e6 * latency.edge_time(h100, branch):.4f} us "
            f"(paper_2020 {1e6 * latency.edge_time(paper, branch):.2f}), cloud_time "
            f"{1e6 * latency.cloud_time(h100, branch):.4f} us "
            f"({1e6 * latency.cloud_time(paper, branch):.2f}), comm_time at level 0 "
            f"{1e3 * latency.comm_time(h100, branch):.3f} ms over "
            f"{h100.uplink_bps / 1e6:.1f} Mbps; measured with every sample offloaded, the "
            f"profile gives them back", timed=True)
    return {"records": records, "cross": cross, "h100": h100}


# ------------------------------------------------------------------ ranks
#: bf16's unit roundoff: 8 significant bits, rounded to nearest
BF16_U = 2.0 ** -8


def ranks_spec(full=True):
    """Phase 14's configurations and sizes: the published ones (`full`),
    or a CPU rehearsal of the same runs (two gloo ranks on the CPU)."""
    from repro_torch.configs import get_config, get_smoke

    if full:
        olmo, granite = get_config("olmo-1b"), get_config("granite-moe-3b-a800m")
        return dict(
            device=None,
            olmo=["--arch", "olmo-1b", "--steps", "3", "--batch", "8", "--seq", "512",
                  "--log-every", "1"],
            twin=olmo.replace(num_layers=2, exit_layers=(0,), exit_loss_weights=(1.0,),
                              dtype="float32"),
            twin_batch=(8, 512), twin_steps=2, alexnet=(256, 3),
            # reduced: 32 -> 4 layers; capacity factor 1.25 -> 1.0, so that
            # tokens drop (a seeded router spreads 2048 x 8 slots over 40
            # experts about evenly, under a 1.25 capacity)
            moe=granite.replace(num_layers=4, exit_layers=(1,), exit_loss_weights=(1.0,),
                                dtype="float32", moe_capacity_factor=1.0),
            moe_batch=(4, 512), fleet_cells=64, scale=(256, 1024))
    return dict(
        device="cpu",
        olmo=["--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
              "--log-every", "1", "--device", "cpu"],
        twin=get_smoke("olmo-1b").replace(dtype="float32"),
        twin_batch=(4, 32), twin_steps=2, alexnet=(16, 2),
        moe=get_smoke("granite-moe-3b-a800m").replace(num_layers=4, dtype="float32",
                                                      moe_capacity_factor=0.5),
        moe_batch=(4, 16), fleet_cells=4, scale=(4, 256))


def ranks_data(spec, train_x, train_y):
    """The global batches phase 14 steps on, from seeded numpy: the twin's
    and the MoE's token windows, B-AlexNet's images from its train split."""
    from repro_torch.data.pipeline import TokenIterator
    from repro_torch.data.synthetic import lm_sequences

    def windows(cfg, shape, n, seed):
        b, s = shape
        it = iter(TokenIterator(lm_sequences(max(50_000, 4 * b * (s + 1)), cfg.vocab_size,
                                             seed=seed), b, s, seed=seed))
        return [next(it) for _ in range(n)]

    rows, steps = spec["alexnet"]
    order = np.random.default_rng(0).permutation(len(train_y))
    return {"twin": windows(spec["twin"], spec["twin_batch"], spec["twin_steps"], 1),
            "moe": windows(spec["moe"], spec["moe_batch"], 1, 2),
            "alexnet": [{"images": train_x[order[i * rows:(i + 1) * rows]],
                         "labels": train_y[order[i * rows:(i + 1) * rows]]}
                        for i in range(steps)]}


def dp_runs(dev, spec, data, mesh):
    """Phase 14's training runs on `dev`, over the data `mesh` (None: one
    rank): (a) `launch.train` on olmo-1b (its own mesh under
    `torch.distributed.run`) and the float32 2-layer twin through
    `make_train_step`, (b) B-AlexNet, (c) the MoE step with its dropped
    (token, slot) counts per layer. Returns plain numbers: each step's
    metrics, ms, peak GB, and each param leaf's float64 sum after."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.launch import train
    from repro_torch.models import convnet, registry
    from repro_torch.training import optim
    from repro_torch.training.loop import make_train_step

    def fresh():
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None

    def sums(params):
        return [float(x.double().sum()) for x in pytree.tree_leaves(params)]

    def steps(cfg, params, opt_cfg, batches, remat=True):
        step = make_train_step(cfg, opt_cfg, remat=remat, device=dev, inplace=True, mesh=mesh)
        state, ms, metrics = optim.init(params), [], []
        for b in batches:
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics, "ms": ms, "peak": peak(), "sums": sums(params)}

    def seeded(cfg):
        gen = torch.Generator(device=dev).manual_seed(0)
        if cfg.family == "convnet":
            return convnet.init_params(gen, device=dev)
        return registry.init_params(gen, cfg, device=dev)

    out = {}
    fresh()
    run = train.main(spec["olmo"])
    out["olmo"] = {"metrics": run["metrics"], "ms": [1e3 * t for t in run["step_s"]],
                   "peak": peak(), "sums": sums(run["params"])}
    del run
    fresh()
    out["twin"] = steps(spec["twin"], seeded(spec["twin"]),
                        optim.AdamWConfig(lr=3e-4, warmup_steps=1,
                                          total_steps=spec["twin_steps"]), data["twin"])
    fresh()
    # phase 4's recipe: AdamW lr 2e-3, warmup 200, no weight decay
    out["alexnet"] = steps(convnet.B_ALEXNET, seeded(convnet.B_ALEXNET),
                           optim.AdamWConfig(lr=2e-3, weight_decay=0.0, total_steps=2000,
                                             warmup_steps=200), data["alexnet"])
    fresh()
    with MoeTap() as tap:
        out["moe"] = steps(spec["moe"], seeded(spec["moe"]), optim.AdamWConfig(), data["moe"])
    b, s = spec["moe_batch"]
    slots = b * s * spec["moe"].moe_top_k
    # the forward's layers (a checkpointed layer's recompute stops before
    # its MoE returns)
    out["moe"]["dropped"] = [round(float(a["moe_dropped_frac"]) * slots) for a in tap.aux]
    out["moe"]["rows"] = tap.rows
    fresh()
    return out


def ranks_fleet(dev, job, want, world, rank, log):
    """Phase 10's 64-cell global-plan arm at codec level 2 and its scale
    arm through the compiled fleet on this rank, sharded over the ranks
    (``mesh="auto"``), each held to phase 10's one-device result."""
    from repro_torch.core.bank import PlanBank
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.fleet import CompiledFleetSimulator, CompiledGateBackend, FleetConfig
    from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet
    from repro_torch.offload import latency

    spec, (val, test) = job["spec"], job["fleet_data"]
    comp = CompiledGateBackend(device=dev)
    n_ctx = len(test["final"])
    glob, bank = OffloadPlan.from_json(job["glob"]), PlanBank.from_json(job["bank"])
    out = {}
    for name, plan, cells, per in (("global_level2", glob.with_compression(2),
                                    spec["fleet_cells"], None),
                                   ("scale", bank) + tuple(spec["scale"])):
        t0 = time.perf_counter()
        scn = reference_fleet(n_cells=cells, val=val, test=test,
                              **({} if per is None else {"requests_per_cell": per}))
        before = log.now()
        sim = CompiledFleetSimulator(fleet_gate_table(plan, scn, backend=comp), scn.topology,
                                     latency.paper_2020(), config=FleetConfig(window_s=0.5))
        assert sim._shard()[:2] == (rank, world), sim._shard()
        t1 = time.perf_counter()
        tel = sim.run()
        wall = time.perf_counter() - t1
        codec = n_ctx if name == "global_level2" else 0
        log.expect(f"{name} over {world} ranks", before, exit_gate=2 * n_ctx, encode=codec,
                   decode=codec)
        same_digest(fleet_digest(tel), want[name], f"{name}: rank {rank} against phase 10",
                    atol=1e-12)
        out[name] = {"requests": scn.topology.n_requests, "set_up_s": t1 - t0, "run_s": wall,
                     "host_s": sim.host_s, "stage_ms": sim.stage_ms}
    return out


def rank_main(out_dir) -> int:
    """One rank of phase 14, under ``torch.distributed.run``: the training
    runs of `dp_runs` over the data mesh, then `ranks_fleet`; the kernels'
    launches counted from 0 over both. Writes rank<r>.json to `out_dir`."""
    import pickle

    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import join_ranks

    with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, backend = join_ranks(job["spec"]["device"])
    dev, rank, world = mesh.device, mesh.coordinate("data"), mesh.axis_size("data")
    log = LaunchLog(dev)
    with open(os.path.join(out_dir, "expect.pkl"), "rb") as f:
        want = pickle.load(f)
    for k in log.counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    rep = {"rank": rank, "world": world, "backend": backend, "device": str(dev),
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    rep.update(dp_runs(dev, job["spec"], job["data"], mesh))
    rep["fleet"] = ranks_fleet(dev, job, want, world, rank, log)
    _sync(dev)
    rep["launches"] = log.now()
    rep["steps"] = log.steps
    rep["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    torch.distributed.destroy_process_group()
    return 0


def bf16_dp_bound(world):
    """Relative bound on the gap between a bf16 data-parallel step's loss
    or grad_norm and the one-rank step's on the same global batch.

    A one-rank bf16 gradient element is rounded to bf16 once, after the
    whole batch is summed; over `world` ranks each rank's partial is
    rounded, then each of the world - 1 sums of the all-reduce, so the two
    differ by at most (world + 1) u relative (u = 2^-8) where the partials
    share a sign, plus the one-rank rounding itself: (world + 2) u, which
    the global norm, a 1-Lipschitz function of the elements, keeps. The
    forward's activations differ only where a GEMM's float32 accumulation
    order depends on the batch rows; each such value is one bf16 rounding
    apart, u. AdamW's first update is lr * g / |g| elementwise, blind to
    a relative change of g, and the later ones move with it at first
    order; the losses of later steps are held to the same (world + 2) u.
    A first-order bound, not a proof: the float32 twin is held to rtol /
    atol 2e-4, the LM tests' tolerance."""
    return (world + 2) * BF16_U


def ms3(xs):
    """A list of times, three decimals each, for a log line."""
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


def gb(x):
    """A peak in GB, for a log line."""
    return "not measured off the card" if x is None else f"{x:.2f} GB"


def ranks_phase(dev, spec, data, fleet, out_dir, timeout=600, say=print):
    """Phase 14: data-parallel training and the compiled fleet over W ranks
    of ``python -m torch.distributed.run --standalone``, each rank this
    script under ``--ranks`` (`rank_main`). W is the card count where it is
    2 or more (NCCL, a card a rank), else 2 ranks sharing the one card
    (gloo), or 2 gloo ranks on the CPU for a rehearsal. The same runs on
    one rank in this process first (`dp_runs`); `fleet` is (val, test,
    plans, phase 10's results). Returns the K1-K4 launches summed over the
    ranks."""
    import pickle

    import torch

    from repro_torch.models.moe import moe_capacity

    world = torch.cuda.device_count() if dev.type == "cuda" else 2
    world = world if world >= 2 else 2
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= world else "gloo"
    os.makedirs(out_dir, exist_ok=True)
    val, test, plans, tels = fleet
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "job.pkl"), "wb") as f:
        pickle.dump({"spec": spec, "data": data, "fleet_data": (val, test),
                     "glob": plans[1].to_json(), "bank": plans[2].to_json()}, f)
    with open(os.path.join(out_dir, "expect.pkl"), "wb") as f:
        pickle.dump({k: fleet_digest(v) for k, v in tels.items()}, f)
    for name in ("rank%d.json" % r for r in range(world)):
        if os.path.exists(os.path.join(out_dir, name)):
            os.remove(os.path.join(out_dir, name))
    say(f"the plans (PlanBank JSON), phase 10's results and the batches written to "
        f"{os.path.relpath(out_dir, ROOT)} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    one = dp_runs(dev, spec, data, None)
    say(f"one rank in this process, {time.perf_counter() - t0:.2f} s: olmo-1b "
        f"{ms3(one['olmo']['ms'])} ms a step, peak {gb(one['olmo']['peak'])}; twin "
        f"{ms3(one['twin']['ms'])} ms; B-AlexNet {ms3(one['alexnet']['ms'])} ms; MoE "
        f"{ms3(one['moe']['ms'])} ms, dropped (token, slot) pairs per layer "
        f"{one['moe']['dropped']}", timed=True)
    assert sum(one["moe"]["dropped"]) > 0, "no token dropped: the MoE check needs drops"
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share the card(s) with this process

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(world), os.path.abspath(__file__), "--ranks", out_dir]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    log_path = os.path.join(out_dir, "ranks.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            if proc.poll() is None:  # torchrun stops its ranks on SIGTERM
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    assert rc == 0, f"the ranks failed ({rc}); their output ends:\n{text[-6000:]}"
    reps = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    say(f"{world} ranks over {backend} (python -m torch.distributed.run --standalone "
        f"--nproc-per-node {world}), {wall:.2f} s from launch to exit: " + "; ".join(
            f"rank {p['rank']} on {p['device']} ({p['card']}, {p['backend']}), its runs "
            f"{p['seconds']:.2f} s" for p in reps), timed=True)
    assert [p["rank"] for p in reps] == list(range(world))
    assert all(p["world"] == world and p["backend"] == backend for p in reps)

    # (a) olmo-1b in bf16: within the derived bound, every rank the same
    bound = bf16_dp_bound(world)
    gaps = []
    for s, step in enumerate(one["olmo"]["metrics"]):
        for k in ("loss", "grad_norm"):
            got, want = reps[0]["olmo"]["metrics"][s][k], step[k]
            gap = abs(got - want) / abs(want)
            gaps.append(gap)
            assert gap <= bound, (f"olmo-1b step {s} {k}: {got} over {world} ranks against "
                                  f"{want} on one, rel {gap:.3g} > {bound:.3g}")
    for name in ("olmo", "twin", "alexnet", "moe"):
        assert all(p[name]["metrics"] == reps[0][name]["metrics"] for p in reps), name
        assert all(p[name]["sums"] == reps[0][name]["sums"] for p in reps), \
            f"{name}: the ranks' params differ"
    say(f"a. launch.train {' '.join(spec['olmo'])}: per-step loss and grad_norm over "
        f"{world} ranks against one rank within rel {max(gaps):.3g} (the derived bf16 bound "
        f"(W + 2) u = {bound:.4g}); ms per step one rank {ms3(one['olmo']['ms'])}, rank 0 "
        f"{ms3(reps[0]['olmo']['ms'])}; peak one rank {gb(one['olmo']['peak'])}, per rank "
        f"{[gb(p['olmo']['peak']) for p in reps]}; every rank's params equal", timed=True)

    def held(name):
        worst = 0.0
        for got, want in zip(reps[0][name]["metrics"], one[name]["metrics"]):
            assert got.keys() == want.keys(), name
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                           err_msg=f"{name} {k}")
                worst = max(worst, abs(got[k] - want[k]) / max(abs(want[k]), 1e-30))
        return worst

    tw = held("twin")
    say(f"float32 twin ({spec['twin'].num_layers} layers, {spec['twin_batch'][0]} x "
        f"{spec['twin_batch'][1]}, {spec['twin_steps']} steps): every metric within rel "
        f"{tw:.3g} of one rank (rtol / atol 2e-4); ms per step {ms3(reps[0]['twin']['ms'])} "
        f"against {ms3(one['twin']['ms'])}", timed=True)
    aw = held("alexnet")
    say(f"b. B-AlexNet, {len(data['alexnet'])} steps at a global {spec['alexnet'][0]}: every "
        f"metric within rel {aw:.3g} of one rank (rtol / atol 2e-4); ms per step "
        f"{ms3(reps[0]['alexnet']['ms'])} against {ms3(one['alexnet']['ms'])}; peak per "
        f"rank {[gb(p['alexnet']['peak']) for p in reps]}", timed=True)
    mw = held("moe")
    for p in reps:
        assert p["moe"]["dropped"] == one["moe"]["dropped"], (p["rank"], p["moe"]["dropped"])
    cfg = spec["moe"]
    cap = moe_capacity(cfg, spec["moe_batch"][0] * spec["moe_batch"][1])
    assert one["moe"]["rows"] == [cap] * len(one["moe"]["rows"]), one["moe"]["rows"]
    for p in reps:  # a rank's buffer holds its kept rows, at most C
        assert len(p["moe"]["rows"]) == len(one["moe"]["rows"])
        assert all(0 < r <= cap for r in p["moe"]["rows"]), (p["rank"], p["moe"]["rows"])
    say(f"c. {cfg.name} widths (d {cfg.d_model}, {cfg.moe_num_experts} experts top-"
        f"{cfg.moe_top_k}) reduced to {cfg.num_layers} layers, capacity factor "
        f"{cfg.moe_capacity_factor}, float32, one step at {spec['moe_batch'][0]} x "
        f"{spec['moe_batch'][1]}: dropped (token, slot) pairs per layer "
        f"{reps[0]['moe']['dropped']} on every rank, as on one; every metric within rel "
        f"{mw:.3g} (rtol / atol 2e-4); expert buffer rows per layer: one rank "
        f"{one['moe']['rows']} (C), " + ", ".join(
            f"rank {p['rank']} {p['moe']['rows']}" for p in reps)
        + f"; ms {ms3(reps[0]['moe']['ms'])} against "
        f"{ms3(one['moe']['ms'])}; peak per rank {[gb(p['moe']['peak']) for p in reps]}",
        timed=True)
    for name in ("global_level2", "scale"):
        f0 = reps[0]["fleet"][name]
        say(f"d. compiled fleet {name}: {f0['requests']} requests over {world} ranks, equal on "
            f"every rank to phase 10's one-device run (columns, summaries; latencies to rel "
            f"1e-9); rank 0: set-up {f0['set_up_s']:.3f} s, run {f0['run_s']:.3f} s (host s "
            + ", ".join(f"{k} {v:.3f}" for k, v in f0["host_s"].items()) + "; device ms "
            + (", ".join(f"{k} {v:.3f}" for k, v in f0["stage_ms"].items())
               or "not measured off the card") + ")", timed=True)
    counts = {}
    for p in reps:
        for k, v in p["launches"].items():
            counts[k] = counts.get(k, 0) + v
    say("launches per rank (K1, K3, K4): " + "; ".join(
        f"rank {p['rank']} {tuple(p['launches'].values())}: " + ", ".join(p["steps"])
        for p in reps))
    return counts


def tp_spec(full=True, uncut=False):
    """Phase 15's runs, each a config and its sizes (prefill (b, s), decode
    steps, lm_engine's codec levels): Qwen2-72B's published widths
    (`full`), or a CPU rehearsal of the same runs on smoke widths. With
    `uncut`, also Qwen2-72B at its published 80 layers, which only a mesh
    of four cards holds (`tools/tp_phase.py`)."""
    from repro_torch.configs import get_config, get_smoke

    if full:
        q, g = get_config("qwen2-72b"), get_config("granite-moe-3b-a800m")
        runs = {
            # reduced: 80 -> 4 layers, the exits (19, 39) moved inside the cut
            "bf16": dict(cfg=q.replace(num_layers=4, exit_layers=(1, 2)), serve=(8, 512),
                         decode=8, levels=(0, 2)),
            # reduced: 80 -> 2 layers, one exit after layer 0, float32
            "f32": dict(cfg=q.replace(num_layers=2, exit_layers=(0,), exit_loss_weights=(1.0,),
                                      dtype="float32"), serve=(4, 128), decode=4, levels=()),
            # reduced: 32 -> 4 layers, float32; capacity factor 1.25 -> 1.0,
            # so that tokens drop
            "moe": dict(cfg=g.replace(num_layers=4, exit_layers=(1,), exit_loss_weights=(1.0,),
                                      dtype="float32", moe_capacity_factor=1.0),
                        serve=(4, 512), decode=0, levels=()),
        }
        if uncut:
            runs["uncut"] = dict(cfg=q, serve=(8, 512), decode=32, levels=(0, 1, 2))
        return dict(device=None, runs=runs)
    q = get_smoke("qwen2-72b")
    runs = {
        "bf16": dict(cfg=q.replace(num_layers=4, exit_layers=(1, 2),
                                   exit_loss_weights=(1.0, 1.0)),
                     serve=(4, 32), decode=4, levels=(0, 2)),
        "f32": dict(cfg=q.replace(num_layers=2, dtype="float32"), serve=(2, 16), decode=2,
                    levels=()),
        "moe": dict(cfg=get_smoke("granite-moe-3b-a800m").replace(
            num_layers=4, dtype="float32", moe_capacity_factor=0.5), serve=(4, 16), decode=0,
            levels=()),
    }
    if uncut:
        runs["uncut"] = dict(cfg=q.replace(num_layers=6, exit_layers=(1, 3),
                                           exit_loss_weights=(1.0, 1.0)),
                             serve=(4, 32), decode=4, levels=(0, 1, 2))
    return dict(device="cpu", runs=runs)


def bf16_roundings(cfg):
    """The bf16 results on a row's way to the logits that a model axis may
    round otherwise than one rank (`bf16_tp_bound`): a decoder-only stack's
    2L + 2, the attention and MLP outputs of each of its L layers, the
    final norm and the head; an encoder-decoder's 2 Le + 3 Ld + 3, one for
    each row-parallel reduce on the row's path (two an encoder layer:
    attention, MLP; three a decoder layer: self-attention, cross-attention,
    MLP), the encoder's final norm, the decoder's and the head."""
    if cfg.is_encoder_decoder:
        return 2 * cfg.encoder_layers + 3 * cfg.num_layers + 3
    return 2 * cfg.num_layers + 2


def bf16_tp_bound(cfg):
    """Relative bound, against max|z|, on the gap between a bf16 model's
    logits over a model axis and one rank's on the same params.

    Each row-parallel product is summed in float32 in another order than
    one rank sums it and rounded once to bf16, as one rank rounds its own
    float32 sum; every other product runs on slices of one rank's
    operands (other GEMM shapes, so another float32 order). Each bf16
    result is then one rank's or its neighbour: at most 2u apart relative
    (u = 2^-8). On the way to the logits the model adds n such results
    (`bf16_roundings`; the embedding is exact, the encoder's frames are
    every rank's). First order, each layer's output no larger than the
    residual it joins: n 2u of max|z|, (2L + 2) 2u for a decoder-only
    stack, (2 Le + 3 Ld + 3) 2u for whisper. A first-order bound, not a
    proof: the float32 twin is held to rtol / atol 2e-4, the LM tests'
    tolerance."""
    return bf16_roundings(cfg) * 2 * BF16_U


def prefill_cost(cfg, b, s, model=1):
    """The dry run's cost (`launch.hlo_cost.analyze` on fake CPU tensors:
    ``flops``, ``peak_bytes``, ...) of one (b, s) prefill step on one card,
    or as rank 0 of a (data 1, model `model`) mesh."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, hlo_cost
    from repro_torch.launch.mesh import make_debug_mesh, record_collectives

    mesh = make_debug_mesh(1, model).as_rank() if model > 1 else None
    with FakeTensorMode(allow_fallback_kernels=False), record_collectives():
        step, args, _ = dryrun.build_step(cfg, ShapeConfig("tp", s, b, "prefill"),
                                          torch.device("cpu"), mesh=mesh)
        return hlo_cost.analyze(step, *args)


def tp_runs(dev, spec, mesh, p_tars=None, names=("bf16", "f32", "moe"), plans=None):
    """The serving runs of phase 15 (and phases 17-18) on `dev` over `mesh`
    (None: one rank), one model at a time, each from `init_params(mesh=)`:
    a prefill step (timed three times, a MoE's routes and drops from the
    first, then once more with every collective timed between two syncs;
    an encoder-decoder's batch with its seeded frames, `enc_frames`),
    decode steps from the prefill's caches (one more timed token), the
    decode's last logits against a prefill over the same tokens, and
    `lm_engine` at the spec's levels (p_tar from `p_tars`, or the one-rank
    prefill's middle exit-0 confidences); with a run's ``calib`` sizes the
    model is calibrated and a plan served (`calibrate_served`: on one rank
    its plan is made, over a mesh the one in `plans` is served). Returns
    numpy outputs, times, peaks (the init's, then the serving's alone), the
    K1/K2/K3/K4 launches (each step's worked out and asserted), the p_tars
    and the plans used."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.core.calibration import TemperatureScaling
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.kernels import calib_nll
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import registry, transformer
    from repro_torch.offload.engine import lm_engine

    card = dev.type == "cuda"
    log = LaunchLog(dev)
    p_tars, plans = dict(p_tars or {}), dict(plans or {})
    res = {"p_tar": p_tars, "plans": plans, "runs": {}}

    def fresh():
        _sync(dev)
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if card else None

    def host(x):
        return x.detach().float().cpu().numpy()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    def share(fn):
        """(ms, all-reduce count, operand GB, ms in all-reduces) of one call
        with every collective timed between two device syncs."""
        with record_collectives(timed=True) as clog:
            _, ms = timed(fn)
        return {"ms": ms, "n": clog.counts.get("all-reduce", 0),
                "gb": clog.bytes.get("all-reduce", 0) / 1e9,
                "ar_ms": 1e3 * clog.seconds.get("all-reduce", 0.0)}

    def run_model(name, cfg, serve, decode, levels, calib=None):
        """One model's runs; every tensor it made is freed on return."""
        (b, s), n_ex = serve, len(cfg.exit_layers)
        fresh()
        params, init_ms = timed(lambda: registry.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev, mesh=mesh))
        init_peak = peak()  # the init's, then the serving's alone
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s + decode)).astype(
            np.int32)
        plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(1.0)]
                           * n_ex)
        r = {"scalars": transformer.num_params(params), "init_ms": init_ms,
             "init_peak": init_peak, "ms": []}
        pre = make_prefill_step(cfg, plan=plan, device=dev, mesh=mesh)
        frames = {"encoder_frames": enc_frames(cfg, b, 2)} if cfg.is_encoder_decoder else {}
        batch = {"tokens": toks[:, :s], **frames}
        tap = MoeTap() if cfg.moe_num_experts else contextlib.nullcontext()
        for i in range(3):
            before = log.now()
            with tap if i == 0 else contextlib.nullcontext():
                o, ms = timed(lambda: pre(params, batch))
            log.expect(f"{name} prefill", before, exit_gate=n_ex)
            r["ms"].append(ms)
            if i == 0:
                first = o
        o = first
        if cfg.moe_num_experts:
            slots = b * s * cfg.moe_top_k
            r["dropped"] = [round(float(a["moe_dropped_frac"]) * slots) for a in tap.aux]
            r["routes"] = {"prefill": tap.routes, "decode": []}
        r["prefill"] = {k: host(o[k]) for k in ("logits", "exit_confidence", "exit_prediction")}
        if mesh is None:  # the exits' logits, whose top-2 gaps decide which rows must agree
            with torch.no_grad():
                zs = registry.forward_prefill(params, cfg, {
                    k: torch.as_tensor(v, device=dev) for k, v in batch.items()})["exit_logits"]
            r["prefill"]["exit_logits"] = [host(z[:, 0]) for z in zs]
            del zs
        assert np.isfinite(r["prefill"]["logits"]).all(), f"{name}: prefill logits not finite"
        if mesh is not None:
            before = log.now()
            r["prefill_share"] = share(lambda: pre(params, batch))
            log.expect(f"{name} prefill, collectives timed", before, exit_gate=n_ex)
        if name not in p_tars:
            c = np.sort(r["prefill"]["exit_confidence"][0])
            p_tars[name] = float(c[len(c) // 2 - 1] + c[len(c) // 2]) / 2
        if decode:
            caches = grow_caches(cfg, o["caches"], b, s + decode + 1, dev, mesh)
            del o, first  # the prefill's caches
            step = make_serve_step(cfg, plan=plan, device=dev, mesh=mesh)
            r["decode"], r["decode_ms"] = [], []
            for t in range(decode):
                before = log.now()
                with tap:
                    d, ms = timed(lambda: step(params, toks[:, s + t:s + t + 1], caches,
                                               s + t)[0])
                log.expect(f"{name} decode", before, exit_gate=n_ex)
                r["decode_ms"].append(ms)
                r["decode"].append({k: host(v) for k, v in d.items()})
                if cfg.moe_num_experts:
                    r["routes"]["decode"].append(tap.routes)
            if mesh is not None:
                before = log.now()
                r["decode_share"] = share(lambda: step(params, toks[:, -1:], caches, s + decode))
                log.expect(f"{name} decode, collectives timed", before, exit_gate=n_ex)
            del caches
            # the decode's last logits against a prefill over the same tokens
            before = log.now()
            full = host(pre(params, {"tokens": toks, **frames})["logits"][:, 0])
            log.expect(f"{name} prefill over the decoded tokens", before, exit_gate=n_ex)
            last = r["decode"][-1]["logits"]
            lo = 0 if last.shape[-1] == full.shape[-1] else \
                mesh.coordinate("model") * last.shape[-1]
            ref_z = full[:, lo:lo + last.shape[-1]]
            r["resume_gap"] = float(np.abs(last - ref_z).max() / np.abs(full).max())
            r["resume_argmax"] = float(np.mean(
                r["decode"][-1]["token"] == full.argmax(-1)))
        r["engine"] = {}
        for level in levels:
            eng = lm_engine(params, cfg, OffloadPlan(
                p_tar=p_tars[name], calibrators=[TemperatureScaling.from_temperature(1.0)]
                * n_ex).with_compression(level), device=dev, mesh=mesh)
            before = log.now()
            got, ms = timed(lambda: eng.infer(batch))
            n_off = eng.stats.offloaded
            codec = 1 if level and n_off else 0
            log.expect(f"{name} lm_engine level {level}", before, exit_gate=1, encode=codec,
                       decode=codec)
            r["engine"][level] = dict({k: np.asarray(v) for k, v in got.items()}, ms=ms,
                                      edge_ms=1e3 * eng.stats.edge_time_s,
                                      cloud_ms=1e3 * eng.stats.cloud_time_s,
                                      payload_bytes=eng.stats.payload_bytes, offloaded=n_off)
        if calib is not None:
            r["calib"] = calibrate_served(dev, name, cfg, params, calib, mesh, log, plans)
        r["peak"] = peak()
        return r

    for name in names:
        if name in spec["runs"]:
            run = spec["runs"][name]
            res["runs"][name] = run_model(name, run["cfg"], run["serve"], run["decode"],
                                          run["levels"], run.get("calib"))
    fresh()
    res["launches"] = {**log.now(), "calib_nll": calib_nll.KERNEL.launches}
    res["steps"] = log.steps
    return res


def tp_rank_main(out_dir) -> int:
    """One rank of phase 15 (`launch_ranks`): `tp_runs` over
    the (data 1, model W) mesh, the kernels' launches counted from 0.
    Writes rank<r>.pkl to `out_dir`."""
    import pickle

    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import join_ranks

    with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, backend = join_ranks(job["spec"]["device"], model=job["model"])
    dev = mesh.device
    for k in LaunchLog(dev).counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = tp_runs(dev, job["spec"], mesh, job["p_tar"], names=("uncut", "bf16", "f32", "moe"))
    res.update(rank=torch.distributed.get_rank(), coords=(mesh.coordinate("data"),
                                                           mesh.coordinate("model")),
               mesh=mesh.shape, backend=backend, device=str(dev),
               card=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               seconds=time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank{res['rank']}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _top2_clear(z, gap):
    """Rows of (b, V) logits whose top-2 gap exceeds `gap`."""
    top2 = np.sort(z, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > gap


def rank_world(dev):
    """(W, backend) of a phase over ranks: the card count where it is 2 or
    more (NCCL, a card a rank), else 2 ranks sharing the one card (gloo),
    or 2 gloo ranks on the CPU for a rehearsal."""
    import torch

    world = max(2, torch.cuda.device_count() if dev.type == "cuda" else 2)
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= world else "gloo"
    return world, backend


def free_port() -> int:
    """A TCP port of this host that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(flag, out_dir, world, job, timeout, meanwhile=None):
    """Run W = `world` ranks of this script with ``flag out_dir``, each a
    process of its own with the environment ``python -m
    torch.distributed.run --standalone --nproc-per-node W`` gives a rank
    (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR 127.0.0.1,
    MASTER_PORT a free port, OMP_NUM_THREADS 1 unless set), which spares
    the launcher's own start (8.5 s on the chip's host, mostly its import
    of torch, before a rank starts its own); `job` pickled to
    out_dir/job.pkl for them, and `meanwhile` (if given) run in this
    process while they run. Each rank writes rank<r>.pkl; their output goes
    to ranks.log beside it, whose tail the failure shows. A rank that fails
    stops the others. Returns (the ranks' results in rank order, seconds
    from launch to exit, what `meanwhile` returned)."""
    import pickle

    import torch

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "job.pkl"), "wb") as f:
        pickle.dump(dict(job, launched=time.time()), f)
    for r in range(world):
        if os.path.exists(os.path.join(out_dir, f"rank{r}.pkl")):
            os.remove(os.path.join(out_dir, f"rank{r}.pkl"))
    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # the ranks share the card(s) with this process
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
        LOCAL_WORLD_SIZE=str(world))
    env.setdefault("OMP_NUM_THREADS", "1")
    log_path = os.path.join(out_dir, "ranks.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, out_dir],
                                  stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT,
                                  env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
                 for r in range(world)]
        try:
            extra = meanwhile() if meanwhile is not None else None
            while True:
                rcs = [proc.poll() for proc in procs]
                failed = [c for c in rcs if c not in (None, 0)]
                if failed or all(c == 0 for c in rcs):
                    rc = failed[0] if failed else 0
                    break
                if time.perf_counter() - t0 > timeout:
                    rc = "timeout"
                    break
                time.sleep(0.05)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    assert rc == 0, f"the ranks failed ({rc}); their output ends:\n{text[-6000:]}"
    reps = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            reps.append(pickle.load(f))
    return reps, wall, extra


def check_reps(reps, world, backend):
    """The ranks of a (data 1, model W) mesh, in rank order, over `backend`."""
    assert [p["rank"] for p in reps] == list(range(world))
    assert all(p["backend"] == backend and p["mesh"] == (1, world) for p in reps)
    assert [p["coords"] for p in reps] == [(0, m) for m in range(world)]


def rerouted(got, want, b, s):
    """Where a rank routed tokens of a bf16 MoE model's serving run
    otherwise than one rank did: a token whose router input differs by a
    rounding can change its top-k experts where two of them nearly tie,
    and its output then differs by far more than the rounding, as, through
    the mixers, the later tokens of its row do a little. From the routes of
    every MoE call (`MoeTap`), per compared step (the prefill's last
    position, then each decode step): (rows with a rerouted token there or
    before, rows whose compared token itself was rerouted), and the
    rerouted token count of each prefill call."""
    flips = [(g != w).any(-1).reshape(b, s) for g, w in zip(got["prefill"], want["prefill"])]
    seen = np.zeros(b, dtype=bool)
    for f in flips:
        seen |= f.any(-1)
    steps = [(seen.copy(), np.any([f[:, -1] for f in flips], axis=0))]
    for g_t, w_t in zip(got["decode"], want["decode"]):
        own = np.any([(g != w).any(-1) for g, w in zip(g_t, w_t)], axis=0)
        seen |= own
        steps.append((seen.copy(), own))
    return steps, [int(f.sum()) for f in flips]


def held_serving(one, reps, name, bound=None):
    """Every rank's serving outputs of run `name` (`tp_runs`) against one
    rank's: the logits within `bound` of max|z| (bf16) or at rtol / atol
    2e-4 (float32, no bound); predictions and gate decisions equal
    wherever one rank's margins clear that gap delta (a top-2 gap above 2
    delta; a confidence farther than conf (e^{2 delta} - 1) + 1e-6 from
    p_tar, hazard d besides); payload_bytes and dropped counts equal. Of a
    bf16 MoE model (`rerouted`), a (row, step) pair whose compared token a
    rank routed otherwise than one rank, in some MoE call, is held to
    finite values only, and each prefill layer's dropped count may move by
    its rerouted tokens (each moves one slot); a pair whose own token was
    routed alike is held as above, also where an earlier token of its row
    was rerouted. Returns (the worst gap held, relative to max|z|, the
    predictions and decisions held equal, the pairs held to finite values
    only, and the worst gap held among the pairs with an earlier token
    rerouted, both over the ranks)."""
    want, p_tar = one["runs"][name], one["p_tar"][name]
    tol = dict(rtol=2e-4, atol=2e-4)

    def delta(z):
        m = float(np.abs(z).max())
        return bound * m if bound else 2e-4 * (1 + m)

    def same_argmax(got_pred, z):
        if not z.size:  # no row held
            return 0
        clear = _top2_clear(z, 2 * delta(z))
        np.testing.assert_array_equal(got_pred[clear], z.argmax(-1)[clear], err_msg=name)
        return int(clear.sum())

    def same_decisions(got_on, want_conf, z):
        if not z.size:
            return 0
        clear = np.abs(want_conf - p_tar) > want_conf * np.expm1(2 * delta(z)) + BOUNDARY
        np.testing.assert_array_equal(got_on[clear], (want_conf >= p_tar)[clear],
                                      err_msg=name)
        return int(clear.sum())

    worst, decided, unheld, carried = 0.0, 0, 0, 0.0
    for p in reps:
        got = p["runs"][name]
        b = len(want["prefill"]["logits"])
        n_steps = 1 + len(want.get("decode", []))
        steps, flips = [(np.zeros(b, dtype=bool),) * 2] * n_steps, None
        if bound is not None and "routes" in want:
            steps, flips = rerouted(got["routes"], want["routes"], b,
                                    len(want["routes"]["prefill"][0]) // b)
        keep, keep_t = ~steps[0][1], [~own for _, own in steps[1:]]
        pairs = [(got["prefill"]["logits"][:, 0], want["prefill"]["logits"][:, 0])]
        pairs += [(d["logits"], w["logits"]) for d, w in zip(got.get("decode", []),
                                                             want.get("decode", []))]
        for (g, w), (seen, own) in zip(pairs, steps):  # decode: the rank's vocab shard
            assert np.isfinite(g).all(), name
            lo = 0 if g.shape[-1] == w.shape[-1] else p["coords"][1] * g.shape[-1]
            ws = w[:, lo:lo + g.shape[-1]]
            rel = np.abs(g - ws).max(-1) / np.abs(w).max()
            unheld += int(own.sum())
            if (seen & ~own).any():
                carried = max(carried, float(rel[seen & ~own].max()))
            if own.all():
                continue
            gap = float(rel[~own].max())
            worst = max(worst, gap)
            if bound is None:
                np.testing.assert_allclose(g, ws, **tol, err_msg=name)
            else:
                assert gap <= bound, (f"{name}: rank {p['rank']} logits rel {gap:.3g} > "
                                      f"{bound:.3g}")
        decided += same_argmax(got["prefill"]["logits"][keep, 0].argmax(-1),
                               want["prefill"]["logits"][keep, 0])
        for d, w, k in zip(got.get("decode", []), want.get("decode", []), keep_t):
            decided += same_argmax(d["token"][k], w["logits"][k])
        for i, ze in enumerate(want["prefill"]["exit_logits"]):
            gc, wc = got["prefill"]["exit_confidence"][i], want["prefill"]["exit_confidence"][i]
            if bound is None:
                np.testing.assert_allclose(gc, wc, **tol, err_msg=name)
            decided += same_argmax(got["prefill"]["exit_prediction"][i][keep], ze[keep])
            decided += same_decisions((gc >= p_tar)[keep], wc[keep], ze[keep])
        for level, w in want["engine"].items():  # its gate is exit 0's on the same rows
            g = got["engine"][level]
            assert g["payload_bytes"] == w["payload_bytes"], (name, level)
            decided += same_decisions(g["on_device"][keep],
                                      want["prefill"]["exit_confidence"][0][keep],
                                      want["prefill"]["exit_logits"][0][keep])
        if "dropped" in want:
            slack = flips or [0] * len(want["dropped"])
            assert all(abs(g - w) <= f for g, w, f in zip(got["dropped"], want["dropped"],
                                                           slack)), (
                name, got["dropped"], want["dropped"], slack)
    return worst, decided, unheld, carried


def serve_shares(r):
    """A serving run's all-reduces' share of a synced prefill and token."""
    out = []
    for k in ("prefill_share", "decode_share"):
        if k in r:
            s = r[k]
            out.append(f"{k.split('_')[0]}: {s['n']} all-reduces of {s['gb']:.3f} GB, "
                       f"{s['ar_ms']:.2f} of {s['ms']:.2f} ms ({s['ar_ms'] / s['ms']:.1%})")
    return "; ".join(out)


def engine_line(r):
    """A serving run's lm_engine levels: ms (edge, cloud), offloads, bytes."""
    return ", ".join(f"level {lv} {e['ms']:.1f} ms (edge {e['edge_ms']:.1f}, cloud "
                     f"{e['cloud_ms']:.1f}), {e['offloaded']} offloaded, {e['payload_bytes']} "
                     f"payload bytes" for lv, e in r["engine"].items())


def summed_launches(reps):
    """The kernels' launches summed over the ranks."""
    counts = {}
    for p in reps:
        for k, v in p["launches"].items():
            counts[k] = counts.get(k, 0) + v
    return counts


def uncut_serving_line(cfg, serve, r0, reps, world, flops, extra=""):
    """Run (d) of phase 15 and its phase 17 counterpart: a model served
    uncut over the mesh."""
    b, s = serve
    for p in reps:
        u = p["runs"]["uncut"]
        assert u["scalars"] * world >= cfg.param_count(), (u["scalars"], cfg.param_count())
        assert all(np.isfinite(d["logits"]).all() for d in u["decode"])
    best = min(r0["ms"])
    return (f"{cfg.name} uncut ({cfg.num_layers} layers, param_count {cfg.param_count()}), "
            f"bf16 through the sharded init in {r0['init_ms'] / 1e3:.1f} s: "
            f"{[p['runs']['uncut']['scalars'] for p in reps]} scalars a rank, peak "
            f"{[gb(p['runs']['uncut']['init_peak']) for p in reps]} drawing them and "
            f"{[gb(p['runs']['uncut']['peak']) for p in reps]} serving{extra}; prefill "
            f"{b} x {s} ms {ms3(r0['ms'])} "
            f"({flops:.4g} FLOPs: {flops / (best * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{flops / (best * 1e-3) / (world * BF16_FLOP_PER_S):.1%} of {world} x 989 TFLOP/s); "
            f"{len(r0['decode'])} tokens from a {s + len(r0['decode']) + 1}-slot cache filled by "
            f"the prefill, ms a token {ms3(r0['decode_ms'])}; the last "
            f"token's logits against a prefill over the same tokens: rel {r0['resume_gap']:.3g}"
            f" of max|z|, argmax equal on {r0['resume_argmax']:.0%} of rows; {serve_shares(r0)}; "
            f"lm_engine {engine_line(r0)}")


def tp_phase(dev, spec, out_dir, timeout=900, say=print):
    """Phase 15: LM serving with the parameters split over a model axis of
    W ranks (each a process of this script under ``--tp``, `tp_rank_main`,
    with the rank environment of ``torch.distributed.run``, `launch_ranks`; W and the backend as
    `rank_world` picks them); the mesh is (data 1, model W). The same runs
    first on one rank in this process (`tp_runs`; its launches kept out of
    the phase's counts), which then frees its cache; each rank's outputs
    are held to them (`held_serving`): the bf16 model within
    `bf16_tp_bound`, the float32 twin and the MoE at rtol / atol 2e-4,
    predictions and decisions equal where one rank's margins clear that,
    payload_bytes and dropped counts equal. Returns the K1-K4 launches
    summed over the ranks."""
    world, backend = rank_world(dev)
    t0 = time.perf_counter()
    # the one-rank reference's launches stay out of the phase's counts: the
    # ranks' runs are the path, each rank counting its own from 0
    counters = LaunchLog(dev).counters
    before = {n: k.launches for n, k in counters.items()}
    one = tp_runs(dev, spec, None)
    for n, k in counters.items():
        k.launches = before[n]
    say(f"one rank in this process, {time.perf_counter() - t0:.2f} s: " + "; ".join(
        f"{n} {r['scalars']} scalars, prefill {ms3(r['ms'])} ms, peak {gb(r['peak'])}"
        for n, r in one["runs"].items()), timed=True)
    # the dry run's FLOPs of the prefills (a trace on fake CPU tensors)
    # while the ranks run
    reps, wall, flops = launch_ranks(
        "--tp", out_dir, world, {"spec": spec, "p_tar": one["p_tar"], "model": world}, timeout,
        meanwhile=lambda: {n: prefill_cost(r["cfg"], *r["serve"])["flops"]
                           for n, r in spec["runs"].items() if n in ("bf16", "uncut")})
    say(f"{world} ranks over {backend}, mesh (data 1, model {world}) (processes "
        f"of this script with torch.distributed.run's rank environment, `launch_ranks`), "
        f"{wall:.2f} s from "
        f"launch to exit: " + "; ".join(
            f"rank {p['rank']} on {p['device']} ({p['card']}, {p['backend']}), its runs "
            f"{p['seconds']:.2f} s" for p in reps), timed=True)
    check_reps(reps, world, backend)

    runs = spec["runs"]
    bound = bf16_tp_bound(runs["bf16"]["cfg"])
    gap, n, *_ = held_serving(one, reps, "bf16", bound)
    cfg, r0, w0 = runs["bf16"]["cfg"], reps[0]["runs"]["bf16"], one["runs"]["bf16"]
    agree = [float(np.mean(p["runs"]["bf16"]["prefill"]["exit_prediction"]
                           == w0["prefill"]["exit_prediction"])) for p in reps]
    say(f"a. {cfg.name} widths (d {cfg.d_model}, {cfg.num_heads} heads, kv {cfg.num_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) reduced to {cfg.num_layers} layers, exits "
        f"{cfg.exit_layers}, bf16, {r0['scalars']} scalars a rank of {w0['scalars']}: prefill "
        f"{runs['bf16']['serve'][0]} x {runs['bf16']['serve'][1]}, {len(r0['decode'])} decode "
        f"steps from its caches, lm_engine at levels {tuple(r0['engine'])}: every rank within "
        f"rel {gap:.3g} "
        f"of one rank (the derived bound (2L + 2) 2u = {bound:.4g}); {n} predictions and "
        f"decisions equal where one rank's margins clear the bound, exit predictions equal "
        f"on {min(agree):.0%} of rows (not held); payload_bytes equal; prefill ms one rank "
        f"{ms3(w0['ms'])}, rank 0 {ms3(r0['ms'])} ({flops['bf16']:.4g} FLOPs, "
        f"{flops['bf16'] / (min(r0['ms']) * 1e-3) / 1e12:.1f} TFLOP/s over the {world} ranks); "
        f"decode ms a token one rank {ms3(w0['decode_ms'])}, rank 0 {ms3(r0['decode_ms'])}; "
        f"{serve_shares(r0)}; lm_engine one rank {engine_line(w0)}; rank 0 {engine_line(r0)}; "
        f"peak per rank {[gb(p['runs']['bf16']['peak']) for p in reps]} (one rank "
        f"{gb(w0['peak'])})", timed=True)
    gap, n, *_ = held_serving(one, reps, "f32")
    cfg, r0 = runs["f32"]["cfg"], reps[0]["runs"]["f32"]
    say(f"b. float32 twin ({cfg.num_layers} layers, exits {cfg.exit_layers}, "
        f"{runs['f32']['serve'][0]} x {runs['f32']['serve'][1]}, {len(r0['decode'])} decode "
        f"steps): every rank within rel {gap:.3g} (rtol / atol 2e-4), {n} predictions and "
        f"decisions equal where one rank's margins clear the tolerance; prefill ms "
        f"{ms3(r0['ms'])} against {ms3(one['runs']['f32']['ms'])}", timed=True)
    gap, n, *_ = held_serving(one, reps, "moe")
    cfg, r0 = runs["moe"]["cfg"], reps[0]["runs"]["moe"]
    assert sum(r0["dropped"]) > 0, "no token dropped: the MoE check needs drops"
    say(f"c. {cfg.name} widths ({cfg.moe_num_experts} experts top-{cfg.moe_top_k}, "
        f"{cfg.moe_num_experts // world} a rank) reduced to {cfg.num_layers} layers, capacity "
        f"factor {cfg.moe_capacity_factor}, float32, prefill {runs['moe']['serve'][0]} x "
        f"{runs['moe']['serve'][1]}: dropped (token, slot) pairs per layer {r0['dropped']} on "
        f"every rank, as on one; logits within rel {gap:.3g} (rtol / atol 2e-4); ms "
        f"{ms3(r0['ms'])} against {ms3(one['runs']['moe']['ms'])}; {serve_shares(r0)}",
        timed=True)
    if "uncut" in runs:
        say("d. " + uncut_serving_line(runs["uncut"]["cfg"], runs["uncut"]["serve"],
                                       reps[0]["runs"]["uncut"], reps, world, flops["uncut"]),
            timed=True)
    say("launches per rank (K1, K3, K4, K2): " + "; ".join(
        f"rank {p['rank']} {tuple(p['launches'].values())}" for p in reps))
    return summed_launches(reps)


# ------------------------------------------------------------ tp_train (16)
# what `tp_train_runs` does besides the steps, by run: a bf16 run reads
# one rank's max|z| (`bf16_tp_train_bound`) and times a split step's
# collectives by pass; a float32 twin holds every step's gradients and the
# params after the steps element by element (`HeldToOneRank`) and writes
# and reloads the ranks' checkpoint
BF16_RUN = dict(zmax=True, share=True)
F32_RUN = dict(held=True, ckpt=True)


def tp_train_spec(full=True, uncut=False):
    """Phase 16's runs, each a config with its (batch, seq) and step count,
    and the calibration and serving sizes of run (d): Qwen3-8B's published
    widths (`full`), or a CPU rehearsal of the same runs on smoke widths.
    With `uncut`, also Qwen3-8B at its published 36 layers, which only a
    mesh of four cards trains (`tools/tp_phase.py`)."""
    from repro_torch.configs import get_config, get_smoke

    if full:
        q, g = get_config("qwen3-8b"), get_config("granite-moe-3b-a800m")
        runs = {
            # reduced: 36 -> 4 layers, the exits (8, 17) moved inside the cut
            "bf16": dict(cfg=q.replace(num_layers=4, exit_layers=(1, 2)), batch=(8, 512),
                         steps=3, levels=(0, 2), **BF16_RUN),
            # reduced: 36 -> 2 layers, one exit after layer 0, float32
            "f32": dict(cfg=q.replace(num_layers=2, exit_layers=(0,), exit_loss_weights=(1.0,),
                                      dtype="float32"), batch=(4, 128), steps=3, **F32_RUN),
            # reduced: 32 -> 4 layers, float32; capacity factor 1.25 -> 1.0,
            # so that tokens drop
            "moe": dict(cfg=g.replace(num_layers=4, exit_layers=(1,), exit_loss_weights=(1.0,),
                                      dtype="float32", moe_capacity_factor=1.0),
                        batch=(4, 512), steps=1, held=True),
        }
        if uncut:
            runs["uncut"] = dict(cfg=q, batch=(8, 512), steps=3, levels=(0, 1, 2), share=True)
        return dict(device=None, runs=runs, val=(8, 128), serve=(8, 512))
    q = get_smoke("qwen3-8b")
    runs = {
        "bf16": dict(cfg=q.replace(num_layers=4, exit_layers=(1, 2),
                                   exit_loss_weights=(1.0, 1.0)), batch=(4, 32), steps=3,
                     levels=(0, 2), **BF16_RUN),
        "f32": dict(cfg=q.replace(dtype="float32"), batch=(4, 16), steps=3, **F32_RUN),
        "moe": dict(cfg=get_smoke("granite-moe-3b-a800m").replace(
            num_layers=4, dtype="float32", moe_capacity_factor=0.5), batch=(4, 16), steps=1,
            held=True),
    }
    if uncut:
        runs["uncut"] = dict(cfg=q.replace(num_layers=6, exit_layers=(1, 3),
                                           exit_loss_weights=(1.0, 1.0)), batch=(4, 32),
                             steps=3, levels=(0, 1, 2), share=True)
    return dict(device="cpu", runs=runs, val=(4, 32), serve=(4, 32))


def bf16_tp_train_bound(cfg, zmax, loss):
    """Relative bound on the gap between a bf16 tensor-parallel train
    step's losses or grad_norm and one rank's on the same params and
    batch, for heads whose logits reach `zmax` in absolute value and
    losses of at least `loss`.

    Forward: the logits differ from one rank's by at most b = n 2u of
    max|z| (`bf16_tp_bound`, u = 2^-8; n the bf16 roundings on a row's
    path, `bf16_roundings`), and a row's cross-entropy moves
    by at most twice the largest logit change (its gradient in z sums to 2
    in absolute value): 2 b max|z| absolute, 2 b max|z| / loss relative.
    Backward: each gradient element passes the same layers in reverse,
    each input gradient's sum over the ranks taken in float32 and rounded
    once, as the forward's partials are: b relative again, which the
    global norm, 1-Lipschitz, keeps. So b max(1, 2 max|z| / loss). AdamW's
    first update is lr * g / |g| elementwise, blind to a relative change
    of g, and the later steps move with it at first order; their losses
    are held to the same bound, max|z| read before and after the steps. A
    first-order bound, not a proof: the float32 twin (run b) and the MoE
    (run c) are held to rtol / atol 2e-4."""
    return bf16_tp_bound(cfg) * max(1.0, 2 * zmax / loss)


def wide_mm_check(dev, cfg, rows, world, seed=3):
    """Run (a)'s two row-parallel products as one of `world` model ranks
    computes them, ``wo`` ((rows, heads x head_dim / W) @ (that, d_model))
    and ``w_down`` ((rows, d_ff / W) @ (that, d_model)), bf16, through
    `layers._WideMM` (the card's float32-output GEMM and its bf16
    backward) on seeded draws, the output gradient exact in bf16 as the
    reduce's rounding hands it over: the forward within K 2^-24 (|x| @ |w|)
    of the float64 sum (float32 accumulation of exact products), the input
    and weight gradients bit for bit one device's bf16 product under
    autograd. Returns per product its shape, the forward's worst gap over
    that bound, and the two gradients' largest gap to float64 relative to
    the gradient's max."""
    import torch

    from repro_torch.models.layers import _WideMM

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for leaf, width in (("wo", cfg.num_heads * cfg.head_dim), ("w_down", cfg.d_ff)):
        k = width // world
        x = torch.randn(rows, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (0.02 * torch.randn(k, cfg.d_model, generator=gen, device=dev)).to(torch.bfloat16)
        g = (1e-3 * torch.randn(rows, cfg.d_model, generator=gen, device=dev)).to(torch.bfloat16)
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = _WideMM.apply(xa, wa)
        y.backward(g.float())
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        (xb @ wb).backward(g)
        assert y.dtype == torch.float32 and xa.grad.dtype == wa.grad.dtype == torch.bfloat16
        assert torch.equal(xa.grad, xb.grad) and torch.equal(wa.grad, wb.grad), leaf
        x64, w64, g64 = x.double(), w.double(), g.double()
        bound = k * 2.0 ** -24 * (x64.abs() @ w64.abs())
        fwd = float(((y.detach().double() - x64 @ w64).abs() / bound).max())
        assert fwd <= 1.0, (leaf, fwd)
        dx, dw = g64 @ w64.T, x64.T @ g64
        out[leaf] = {"shape": (rows, k, cfg.d_model), "fwd": fwd,
                     "dx": float((xa.grad.double() - dx).abs().max() / dx.abs().max()),
                     "dw": float((wa.grad.double() - dw).abs().max() / dw.abs().max())}
        del x, w, g, xa, wa, xb, wb, y, x64, w64, g64, bound, dx, dw
    return out


def model_grad_check(mesh, shape, seed=4):
    """On each model rank of `mesh`: `launch.mesh.model_grad`'s backward on a
    bf16 activation of `shape`, each rank's output gradient its own seeded
    bf16 draw, against the ranks' gradients gathered exactly: one float32
    all-reduce logged under the backward; the float32 sum rounded once to
    bf16, bit for bit with 2 ranks (two float32 addends sum alike in either
    order), and with any number within 2^-8 |s| + (1 + 2^-8) (W - 1) 2^-24
    sum_r |g_r| of the exact sum s. Returns the worst gap over that bound."""
    import torch

    from repro_torch.launch.mesh import gather_blocks, model_grad, record_collectives

    dev, group = mesh.device, mesh.group("model")
    m, w = mesh.coordinate("model"), mesh.axis_size("model")
    g = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed + m),
                    device=dev).to(torch.bfloat16)
    x = torch.zeros(shape, dtype=torch.bfloat16, device=dev, requires_grad=True)
    with record_collectives() as clog:
        model_grad(x, group).backward(g)
    assert clog.by_pass() == {"backward": {"counts": {"all-reduce": 1},
                                           "bytes": {"all-reduce": 4 * x.numel()}}}, \
        clog.by_pass()
    every = gather_blocks(g.float(), m, w, group)
    got = x.grad
    assert got.dtype == torch.bfloat16
    if w == 2:
        assert torch.equal(got, (every[0] + every[1]).to(torch.bfloat16))
    s = every.double().sum(0)
    bound = (2.0 ** -8 * s.abs()
             + (1 + 2.0 ** -8) * (w - 1) * 2.0 ** -24 * every.double().abs().sum(0))
    gap = float(((got.double() - s).abs() / bound.clamp_min(1e-300)).max())
    assert gap <= 1.0, gap
    return gap


def enc_frames(cfg, b, seed):
    """An encoder-decoder's (b, encoder_seq, d_model) frame embeddings (the
    stubbed frontend's output): seeded N(0, 1) draws on the host, in the
    config's dtype, the same in every process."""
    import torch

    from repro_torch.models.layers import cdtype

    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen).to(cdtype(cfg))


def tp_train_batches(cfg, shape, n, seed):
    """`n` (batch, seq) windows of the seeded synthetic stream, as
    `launch.train` reads it, an encoder-decoder's with seeded frames
    (`enc_frames`)."""
    from repro_torch.data.pipeline import TokenIterator
    from repro_torch.data.synthetic import lm_sequences

    b, s = shape
    it = iter(TokenIterator(lm_sequences(max(50_000, 4 * b * (s + 1)), cfg.vocab_size,
                                         seed=seed), b, s, seed=seed))
    out = [next(it) for _ in range(n)]
    if cfg.is_encoder_decoder:
        out = [dict(w, encoder_frames=enc_frames(cfg, b, seed + 1000 * i))
               for i, w in enumerate(out)]
    return out


def model_inputs(batch):
    """A training batch without its labels: what the serve and eval steps
    read."""
    return {k: v for k, v in batch.items() if k != "labels"}


def local_path_tree(tree):
    """{tree path: tensor on the host} of a params or gradient tree."""
    import torch.utils._pytree as pytree

    from repro_torch import sharding

    return {sharding.path_str(p): a.detach().cpu() for p, a in
            pytree.tree_flatten_with_path(tree)[0]}


# Adam's update in 3 steps (b1 0.9, b2 0.95) is at most 1.001 in size.
# Where each step's gradient of an element lies within ADAM_RHO |g| of one
# rank's, its update lies within 2.002 ADAM_RHO / (1 - ADAM_RHO) of one
# rank's, so its param within that times sum(lr): 1.10e-4 at ADAM_RHO 0.1
# and sum(lr) 4.95e-4, under the 2e-4 the params are held to. The other
# elements are open (their gradient is at its rounding's level, which then
# sets Adam's update) and may be at most OPEN_SHARE_MAX of a model's.
ADAM_RHO = 0.1
OPEN_SHARE_MAX = 1e-3


def whole_elements(a, spec, mesh):
    """The elements of a rank's leaf `a` (laid out by `spec`) that every
    model rank holds whole, as one tensor: all of a replicated leaf, the
    whole blocks of a packed dim; None for a split leaf."""
    import torch

    from repro_torch import sharding

    dim, blocks = sharding.model_parts(spec, a.shape, mesh)
    pieces = [part.reshape(-1) for part, (_, split) in
              zip(torch.split(a, [n for n, _ in blocks], dim), blocks) if not split]
    return torch.cat(pieces) if pieces else None


def owned(shape, spec, mesh):
    """A mask over a rank's leaf of `shape` (laid out by `spec`) of the
    elements it counts for the model: its blocks of the split dims, and the
    whole ones on model rank 0 only."""
    import torch

    from repro_torch import sharding

    first = mesh.coordinate("model") == 0
    dim, blocks = sharding.model_parts(spec, shape, mesh)
    line = torch.cat([torch.full((n,), split or first) for n, split in blocks])
    return line.reshape((-1,) + (1,) * (len(shape) - dim - 1)).expand(shape)


def send_msg(sock, obj):
    """A pickled message on a socket, its length first."""
    import pickle
    import struct

    data = pickle.dumps(obj)
    sock.sendall(struct.pack("!Q", len(data)) + data)


def recv_into(sock, view):
    """Fill `view` (a writable byte buffer) from `sock`."""
    view = memoryview(view).cast("B")
    while len(view):
        n = sock.recv_into(view)
        if n == 0:
            raise EOFError("the socket closed")
        view = view[n:]


def recv_msg(sock):
    """A message of `send_msg`."""
    import pickle
    import struct

    head = bytearray(8)
    recv_into(sock, head)
    data = bytearray(struct.unpack("!Q", head)[0])
    recv_into(sock, data)
    return pickle.loads(data)


class OneRankStore:
    """The one-rank run's gradients and params ({key: {path: tensor on the
    host}}, a key (run, "grads", step) or (run, "params")), kept in this
    process's memory and served to the ranks of a (data 1, model W) mesh
    over a local socket (a token of its own to connect): a rank asks for a
    leaf and gets its slice of it only (`sharding.local_shards` under the
    layout, as rank (0, m)), its bytes received straight into a buffer.
    Nothing goes through the disk, which the float32 twin's three steps of
    gradients (27 GB) and its params would otherwise fill."""

    def __init__(self, trees, by_path, world):
        import socket
        import threading

        self.trees, self.by_path, self.world = trees, by_path, world
        self.token = os.urandom(16)
        self.sock = socket.create_server(("localhost", 0))
        self.address = self.sock.getsockname()[:2]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        import threading

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:  # closed
                return
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()

    def _client(self, conn):
        import socket

        import torch

        from repro_torch import sharding
        from repro_torch.launch.mesh import make_debug_mesh

        # a leaf's header and bytes leave at once: with Nagle's algorithm the
        # bytes would wait for the client's delayed ACK of the header (tens
        # of ms a leaf, most of the fetch time of a tree of small leaves)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with conn:
            try:
                if recv_msg(conn) != self.token:
                    return
                while True:
                    key, path, m = recv_msg(conn)
                    mesh = make_debug_mesh(1, self.world).as_rank((0, m))
                    a = sharding.local_shards([self.trees[key][path]],
                                              [self.by_path[key[0]][path]], mesh)[0]
                    a = a.contiguous()
                    send_msg(conn, (str(a.dtype).split(".")[-1], tuple(a.shape)))
                    conn.sendall(a.reshape(-1).view(torch.uint8).numpy())
            except EOFError:
                return

    def ticket(self):
        """What a rank needs to reach the store (`StoreClient`)."""
        return {"address": self.address, "token": self.token}

    def close(self):
        self.sock.close()


class StoreClient:
    """A rank's connection to a `OneRankStore`."""

    def __init__(self, ticket):
        import socket

        self.sock = socket.create_connection(ticket["address"])
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_msg(self.sock, ticket["token"])
        self.seconds = 0.0

    def fetch(self, key, path, m, dev):
        """Rank m's slice of leaf `path` of the store's tree `key`, on `dev`."""
        import torch

        t0 = time.perf_counter()
        send_msg(self.sock, (key, path, m))
        dtype, shape = recv_msg(self.sock)
        out = torch.empty(shape, dtype=getattr(torch, dtype))
        recv_into(self.sock, out.reshape(-1).view(torch.uint8).numpy())
        out = out.to(dev)
        self.seconds += time.perf_counter() - t0
        return out

    def close(self):
        self.sock.close()


def grad_noise(grad_fn, params, batch, grads, seed=5):
    """How far one rank's gradients `grads` of `batch` move, leaf by leaf
    (max|g' - g| / max|g| by tree path), when the step is taken again as
    it was ("repeat") and with every float32 param moved one ulp up or
    down at random ("ulp", the params put back after): the model's own
    spread at float32's rounding, beside which a mesh's gaps are read."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import sharding

    flat = pytree.tree_flatten_with_path(grads)[0]

    def gaps(again):
        return {sharding.path_str(p): float((a - g).abs().max()) / max(float(g.abs().max()),
                                                                        1e-30)
                for (p, g), a in zip(flat, pytree.tree_leaves(again))}

    out = {"repeat": gaps(grad_fn(params, batch)[1])}
    leaves = pytree.tree_leaves(params)
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    up = [torch.rand(p.shape, generator=gen, device=p.device) < 0.5 for p in leaves]

    def move(sign):
        with torch.no_grad():
            for p, u in zip(leaves, up):
                p.copy_(torch.nextafter(p, torch.full_like(p, sign * math.inf).masked_fill_(
                    ~u, -sign * math.inf)))

    move(1)
    try:
        out["ulp"] = gaps(grad_fn(params, batch)[1])
    finally:
        move(-1)
    return out


class HeldToOneRank:
    """A rank's gradients at each step and its params after the steps
    against its blocks of one rank's, which the one-rank run keeps in
    memory and serves slice by slice (`OneRankStore`, reached through
    `ticket`). Gradients: every element within 2e-4 |w| + 2e-4 max|w| of
    the whole leaf (max|w| from the one-rank run); an element is open where
    at some step the rank's gradient lies further than ADAM_RHO |w| from
    one rank's. Params: every element within 2e-4 |w| + 2e-4, the open
    ones 2.002 sum(lr) further (Adam's largest swing in 3 steps); the open
    ones are counted by leaf (each whole element once, on model rank 0),
    for the parent to hold their share to OPEN_SHARE_MAX of the model."""

    def __init__(self, by_path, mesh, dev, ticket):
        self.by_path, self.mesh, self.dev = by_path, mesh, dev
        self.open, self.grad_gaps = {}, []
        self.store = StoreClient(ticket)

    def _mine(self, key, path):
        """This rank's slice of leaf `path` of the one-rank tree `key`."""
        return self.store.fetch(key, path, self.mesh.coordinate("model"), self.dev)

    def grads(self, name, t, grads, tops):
        import torch
        import torch.utils._pytree as pytree

        from repro_torch import sharding

        flat = {sharding.path_str(p): g for p, g in pytree.tree_flatten_with_path(grads)[0]}
        assert sorted(flat) == sorted(tops), name
        self.grad_gaps.append({})
        for path, g in flat.items():
            w, top = self._mine((name, "grads", t), path), tops[path]
            diff = (g - w).abs()
            bad = ~(diff <= 2e-4 * top + 2e-4 * w.abs())
            assert not bool(bad.any()), (
                f"{name} step {t} gradient {path}: {int(bad.sum())} elements apart by up "
                f"to {float(diff[bad].max()):.3g} (max|g| {top:.3g})")
            self.grad_gaps[-1][path] = float(diff.max()) / max(top, 1e-30)
            mask = self.open.setdefault(path, torch.zeros(g.shape, dtype=torch.bool,
                                                          device=self.dev))
            mask |= diff > ADAM_RHO * w.abs()

    def params(self, name, params, lr_sum):
        """Returns (the worst gap of the elements that are not open, the
        open ones past 2e-4 and their worst gap, the open count by leaf)."""
        import torch.utils._pytree as pytree

        from repro_torch import sharding

        extra = 2.002 * lr_sum
        worst, n_out, worst_out, where = 0.0, 0, 0.0, {}
        for p, g in pytree.tree_flatten_with_path(params)[0]:
            path = sharding.path_str(p)
            w, mark = self._mine((name, "params"), path), self.open[path]
            diff, lim = (g - w).abs(), 2e-4 + 2e-4 * w.abs()
            out = mark & ~(diff <= lim)
            n_out += int(out.sum())
            if bool(out.any()):
                worst_out = max(worst_out, float(diff[out].max()))
            bad = ~(diff <= lim + extra * mark)
            assert not bool(bad.any()), (f"{name} params {path}: {int(bad.sum())} elements "
                                         f"apart by up to {float(diff[bad].max()):.3g}")
            worst = max(worst, float(diff.masked_fill(mark, 0.0).max()))
            mine = owned(tuple(mark.shape), self.by_path[path], self.mesh)
            n = int((mark & mine.to(mark.device)).sum())
            if n:
                where[path] = n
        self.store.close()
        return worst, n_out, worst_out, where


def tp_train_runs(dev, spec, mesh, out_dir, names=("bf16", "f32", "moe"), store=None):
    """The training runs of phase 16 (and phase 17) on `dev` over `mesh`
    (None: one rank), one model at a time from `init_params(mesh=)`, with
    `launch.train`'s AdamW (in place, remat), as each run's flags say
    (`BF16_RUN`, `F32_RUN`): the steps; with ``zmax`` one rank reads
    max|z| of every head before and after them; with ``share`` a split step
    is run once more with every collective timed (no update); with
    ``held`` each step's gradients are taken first (`make_grad_fn`): one
    rank keeps them, and its params after the steps, on the host (under
    ``grads`` and ``params``, with each gradient leaf's max|g| under
    ``grad_tops``, and the first step's `grad_noise` under ``grad_noise``),
    and each rank of a mesh holds its blocks to them
    (`HeldToOneRank`; `store` the one-rank run's `OneRankStore.ticket` and
    its maxima by run); with ``ckpt`` the ranks write their checkpoint to
    `out_dir`, one device's file, and reload it; with ``levels``
    the trained model is calibrated and served (`calibrate_and_serve`).
    Over a mesh every element held whole is checked bit-equal over the
    ranks. Returns the numbers, the K1-K4 launches and the steps'
    worked-out counts."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import sharding
    from repro_torch.kernels import calib_nll
    from repro_torch.launch.mesh import all_sum, record_collectives
    from repro_torch.models import registry, transformer
    from repro_torch.training import checkpoint, optim
    from repro_torch.training.loop import make_eval_step, make_grad_fn, make_train_step, whole_specs

    card = dev.type == "cuda"
    log = LaunchLog(dev)
    m_idx = 0 if mesh is None else mesh.coordinate("model")
    res = {"runs": {}}

    def fresh():
        _sync(dev)
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if card else None

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    for name in names:
        if name not in spec["runs"]:
            continue
        run = spec["runs"][name]
        cfg, steps = run["cfg"], run["steps"]
        fresh()
        t_run = time.perf_counter()
        params, init_ms = timed(lambda: registry.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev, mesh=mesh))
        by_path = whole_specs(cfg, mesh)
        opt_cfg = optim.AdamWConfig(lr=3e-4, total_steps=steps,
                                    warmup_steps=min(20, steps // 5 + 1))
        batches = tp_train_batches(cfg, run["batch"], steps, seed=1)
        r = {"scalars": transformer.num_params(params), "init_ms": init_ms, "metrics": [],
             "ms": []}
        step = make_train_step(cfg, opt_cfg, remat=True, device=dev, inplace=True, mesh=mesh)
        state = optim.init(params)
        zmax = grad_fn = held = None
        if mesh is None and run.get("zmax"):
            # max|z| of every head, before and after the steps, for
            # `bf16_tp_train_bound`
            ev = make_eval_step(cfg, device=dev)

            def zmax():
                o = ev(params, model_inputs(batches[0]))
                return max(float(z.abs().max()) for z in [o["logits"]] + o["exit_logits"])

            r["zmax"] = [zmax()]
        if run.get("held"):
            # each step's gradients first, at the params the step sees: one
            # rank writes them, a rank of the mesh holds its blocks to them
            grad_fn = make_grad_fn(cfg, device=dev, mesh=mesh)
            if mesh is None:
                r["grad_tops"], r["grads"] = [], []
            else:
                held = HeldToOneRank(by_path, mesh, dev, store["ticket"])
        tap = MoeTap() if cfg.moe_num_experts else contextlib.nullcontext()
        dropped, routes = [], []
        t_held = time.perf_counter()
        r["setup_s"] = t_held - t_run  # the init, the batches, the steps' specs, the moments
        for i, b in enumerate(batches):
            if grad_fn is not None:
                _, grads, _ = grad_fn(params, b)
                if mesh is None:
                    tree = local_path_tree(grads)
                    r["grad_tops"].append({p: float(a.abs().max()) for p, a in tree.items()})
                    r["grads"].append(tree)
                    if i == 0:
                        r["grad_noise"] = grad_noise(grad_fn, params, b, grads)
                else:
                    held.grads(name, i, grads, store["tops"][name][i])
                del grads
            before = log.now()
            with tap:
                (_, _, m), ms = timed(lambda: step(params, state, b))
            log.expect(f"{name} train step", before)
            r["ms"].append(ms)
            r["metrics"].append({k: float(v) for k, v in m.items()})
            if cfg.moe_num_experts:
                slots = run["batch"][0] * run["batch"][1] * cfg.moe_top_k
                dropped += [round(float(a["moe_dropped_frac"]) * slots) for a in tap.aux]
                routes += tap.routes
        r["steps_s"] = time.perf_counter() - t_held  # with each step's held gradients
        del m
        if zmax is not None:
            r["zmax"].append(zmax())
        if cfg.moe_num_experts:
            r["dropped"], r["routes"] = dropped, routes
        r["lr_sum"] = sum(float(optim.schedule(opt_cfg, t)) for t in range(1, steps + 1))
        r["peak"] = peak()
        if mesh is not None and run.get("share"):
            # the step's forward and backward once more, every collective
            # timed between two syncs (no update)
            grad_fn = make_grad_fn(cfg, device=dev, mesh=mesh)
            with record_collectives(timed=True) as clog:
                _, ms = timed(lambda: grad_fn(params, batches[0]))
            r["share"] = {"ms": ms, "passes": {p: {
                "n": d["counts"].get("all-reduce", 0),
                "gb": d["bytes"].get("all-reduce", 0) / 1e9,
                "ms": 1e3 * d["seconds"].get("all-reduce", 0.0)} for p, d in clog.passes.items()}}
        del state
        if mesh is not None:
            # every element held whole (a replicated leaf, a packed leaf's
            # whole blocks), bit for bit the same on every model rank: each
            # rank's bytes, as int32 words, against model rank 0's, which
            # one all-reduce of rank 0's words and the other ranks' zeros
            # hands every rank exactly
            t0 = time.perf_counter()
            group = mesh.group("model")
            n_rep = 0
            for p, a in pytree.tree_flatten_with_path(params)[0]:
                whole = whole_elements(a.detach(), by_path[sharding.path_str(p)], mesh)
                if whole is not None:
                    raw = whole.reshape(-1).view(torch.uint8)
                    words = torch.nn.functional.pad(raw, (0, -raw.numel() % 4)).view(torch.int32)
                    first = words.clone() if m_idx == 0 else torch.zeros_like(words)
                    all_sum(first, group)
                    assert torch.equal(first, words), (name, sharding.path_str(p))
                    n_rep += whole.numel()
                    del raw, words, first
            r["replicated_equal"], r["replicated_s"] = n_rep, time.perf_counter() - t0
        if run.get("held"):
            if mesh is None:
                r["params"] = local_path_tree(params)
            else:
                r["held"] = held.params(name, params, r["lr_sum"])
                r["grad_gaps"], r["fetch_s"], held = held.grad_gaps, held.store.seconds, None
        if mesh is not None and run.get("ckpt"):
            # the checkpoint of the ranks' slices, one device's file
            path = os.path.join(out_dir, f"{name}.msgpack")
            specs = sharding.lay_over(params, by_path)
            t0 = time.perf_counter()
            checkpoint.save(path, params, mesh, specs)
            torch.distributed.barrier()
            r["ckpt_save_s"] = time.perf_counter() - t0
            back = checkpoint.load(path, params, mesh, specs)
            r["ckpt_back"] = all(torch.equal(a, b) for a, b in zip(
                pytree.tree_leaves(back), pytree.tree_leaves(params)))
            assert r["ckpt_back"], "the reloaded checkpoint differs from the rank's slices"
            r["ckpt_s"] = time.perf_counter() - t0
            del back
        r["train_s"] = time.perf_counter() - t_run
        if "levels" in run:
            r["serve"] = calibrate_and_serve(dev, spec, name, cfg, params, run["levels"], mesh,
                                             log)
        r["seconds"] = time.perf_counter() - t_run
        res["runs"][name] = r
        del params
    fresh()
    res["launches"] = {**log.now(), "calib_nll": calib_nll.KERNEL.launches}
    res["steps"] = log.steps
    return res


def fit_exits(dev, name, cfg, params, val, mesh, log):
    """The eval step's whole-vocab exit logits of a seeded validation batch
    of `val` (b, s) over `mesh` (None: one rank), gathered there; each exit's
    temperature on them by K2 from the best point of `K2_GRID` and by the
    plain fit, held to each other (by T or by NLL, as phase 12); then exit
    0's on labels planted at T* = 1.5, by both (by T, as phase 11). The K2
    launches are worked out and asserted. Returns {"eval_ms", "fits":
    [(K2 T, plain T, K2 NLL, plain NLL)] by exit, "planted": (K2 T, plain T)}."""
    import torch

    from repro_torch.core.calibration import fit_temperature, nll
    from repro_torch.kernels import calib_nll, ops
    from repro_torch.training.loop import make_eval_step

    V, k2 = cfg.vocab_size, calib_nll.KERNEL
    vb = tp_train_batches(cfg, val, 1, seed=5)[0]
    t0 = time.perf_counter()
    ev = make_eval_step(cfg, device=dev, mesh=mesh)(params, model_inputs(vb))
    _sync(dev)
    eval_ms = 1e3 * (time.perf_counter() - t0)
    zs = [z.reshape(-1, V) for z in ev["exit_logits"]]
    del ev
    y = torch.as_tensor(vb["labels"], device=dev).reshape(-1).to(torch.int64)
    assert all(z.shape == (y.numel(), V) and bool(torch.isfinite(z).all()) for z in zs)
    before = k2.launches
    fits = []
    for z in zs:
        tp, _ = fit_temperature(z.float(), y)
        start = min(K2_GRID, key=lambda t: float(ops.calib_stats(z, y, t)[0]))
        tk, _ = ops.fit_temperature_kernel(z, y, t0=start)
        tp, tk = float(tp), float(tk)
        n_p, n_k = float(nll(z.float(), y, tp)), float(nll(z.float(), y, tk))
        assert abs(tk - tp) <= 1e-3 * tp or abs(n_k - n_p) <= 1e-6 * abs(n_p), (name, tk, tp)
        fits.append((tk, tp, n_k, n_p))
    gen = torch.Generator(device=dev).manual_seed(1)
    zp = zs[0].repeat(4, 1)
    yp = torch.multinomial(torch.softmax(zp.float() / 1.5, dim=-1), 1, generator=gen)[:, 0]
    tk_p = float(ops.fit_temperature_kernel(zp, yp)[0])
    tr_p = float(fit_temperature(zp.float(), yp)[0])
    assert abs(tk_p - tr_p) <= 1e-3 * tr_p and 1.2 < tr_p < 1.9, (name, tk_p, tr_p)
    del zp, yp
    want_k2 = len(zs) * (len(K2_GRID) + 25) + 25 if log.card else 0
    assert k2.launches - before == want_k2, (name, k2.launches - before, want_k2)
    log.steps.append(f"{name} K2 fits ({want_k2} K2)")
    return {"eval_ms": eval_ms, "fits": fits, "planted": (tk_p, tr_p)}


def calibrate_and_serve(dev, spec, name, cfg, params, levels, mesh, log):
    """Run (d) on a trained model over `mesh` (None: one rank): the eval
    step's whole-vocab exit logits of a validation batch; each exit's K2
    fit held to the plain fit (by T or NLL, as phase 12) and, on labels
    planted at T* = 1.5, by T (as phase 11); two `OffloadPlan`s, of the
    K2 temperatures and of the same with exit 0's planted-label fit, each
    with p_tar at the widest ratio between two neighbouring exit-0
    confidences of the serving batch; `lm_engine` at `levels` under each.
    Over a mesh, rank 0 then serves the same weights gathered whole on one
    rank (its launches kept out of the counts): the mesh's gate
    confidences held to its within the bf16 bound, its decisions away from
    p_tar +- 1e-6, payload_bytes per refused row equal. Returns the
    numbers."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import sharding
    from repro_torch.core.calibration import TemperatureScaling
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.kernels import calib_nll
    from repro_torch.launch.mesh import gather_whole
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import transformer
    from repro_torch.offload.engine import lm_engine
    from repro_torch.training.loop import whole_specs

    n_ex, k2 = len(cfg.exit_layers), calib_nll.KERNEL
    out = fit_exits(dev, name, cfg, params, spec["val"], mesh, log)
    # two plans: the K2 temperatures on the token labels (the pipeline's),
    # and the same with exit 0 at its planted-label fit, whose confidences
    # spread over (0, 1) where the first's sit near 1 / V
    temps = [f[0] for f in out["fits"]]
    plans = {"fit": temps, "planted": [out["planted"][0]] + temps[1:]}
    batch = {"tokens": tp_train_batches(cfg, spec["serve"], 1, seed=6)[0]["tokens"]}
    out["plans"] = {}

    def engines(p, m, plan):
        got = {}
        for level in levels:
            eng = lm_engine(p, cfg, plan.with_compression(level), device=dev, mesh=m)
            before = log.now()
            t0 = time.perf_counter()
            r = eng.infer(batch)
            _sync(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            n_off = eng.stats.offloaded
            codec = 1 if level and n_off else 0
            log.expect(f"{name} lm_engine level {level}", before, exit_gate=1, encode=codec,
                       decode=codec)
            got[level] = dict({k: np.asarray(v) for k, v in r.items()}, ms=ms,
                              payload_bytes=eng.stats.payload_bytes, offloaded=n_off)
        return got

    for key, ts in plans.items():
        plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(t)
                                                   for t in ts])
        before = log.now()
        pre = make_prefill_step(cfg, plan=plan, device=dev, mesh=mesh)(params, batch)
        log.expect(f"{name} prefill", before, exit_gate=n_ex)
        # p_tar in the middle (geometric) of the widest ratio between two
        # neighbouring exit-0 confidences: both outcomes occur, and a row's
        # confidence is as far from it, relative, as the batch allows
        c_mesh = pre["exit_confidence"][0].double().cpu()
        c = torch.sort(c_mesh)[0]
        i = int(torch.argmax(c[1:].log() - c[:-1].log()))
        plan = plan.with_p_tar(float((c[i] * c[i + 1]).sqrt()))
        del pre
        out["plans"][key] = {"plan": plan, "c_mesh": c_mesh,
                             "engine": engines(params, mesh, plan)}
    if mesh is not None:
        # one rank's serving of the same trained weights: rank 0, after
        # every rank took part in gathering them whole
        by_path = whole_specs(cfg, mesh)
        whole = gather_whole(params, sharding.lay_over(params, by_path), mesh)
        if mesh.coordinate("model") == 0:
            kept = {n: k.launches for n, k in LaunchLog(dev).counters.items()}
            kept_k2, steps = k2.launches, len(log.steps)
            one = pytree.tree_map(lambda a: a.to(dev), whole)
            del whole
            with torch.no_grad():
                z0 = transformer.forward_prefill(one, cfg, {"tokens": torch.as_tensor(
                    batch["tokens"], device=dev)})["exit_logits"][0][:, 0]
            for key, d in out["plans"].items():
                plan = d["plan"]
                zc = plan.calibrated_logits(z0, 0)
                # the gate's confidences, one rank's against the mesh's,
                # within the bf16 bound on the calibrated logits
                c_one = torch.softmax(zc.float(), dim=-1).amax(-1).double().cpu()
                delta = bf16_tp_bound(cfg) * float(zc.float().abs().max())
                gap = float(((d["c_mesh"] - c_one).abs() / c_one).max())
                assert gap <= np.expm1(2 * delta), (name, key, gap, delta)
                ref = engines(one, None, plan)
                # decisions held to one rank's away from p_tar +- 1e-6
                # (hazard d)
                clear = ((c_one - plan.p_tar).abs() > BOUNDARY).numpy()
                for level, w in ref.items():
                    g = d["engine"][level]
                    np.testing.assert_array_equal(g["on_device"][clear], w["on_device"][clear],
                                                  err_msg=f"{name} {key} level {level}")
                    # the payload counted once per refused row, as one rank does
                    assert (g["payload_bytes"] * w["offloaded"]
                            == w["payload_bytes"] * g["offloaded"]), (name, key, level)
                d["one_rank"] = {
                    "ms": {lv: w["ms"] for lv, w in ref.items()}, "clear": int(clear.sum()),
                    "rows": int(clear.size), "conf_gap": gap,
                    "conf_bound": float(np.expm1(2 * delta)),
                    "equal": all(np.array_equal(d["engine"][lv]["on_device"], w["on_device"])
                                 for lv, w in ref.items())}
            del one, z0
            for n, k in LaunchLog(dev).counters.items():
                k.launches = kept[n]
            k2.launches = kept_k2
            del log.steps[steps:]
        else:
            del whole
    for d in out["plans"].values():
        d["p_tar"], d["temperatures"] = d["plan"].p_tar, d["plan"].temperatures
        del d["plan"], d["c_mesh"]
    return out


def tp_train_rank_main(out_dir) -> int:
    """One rank of phase 16 (`launch_ranks`): `tp_train_runs`
    over the (data 1, model W) mesh, the kernels' launches counted from 0.
    Writes rank<r>.pkl to `out_dir`."""
    import pickle

    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import calib_nll
    from repro_torch.launch.mesh import join_ranks

    with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, backend = join_ranks(job["spec"]["device"], model=job["model"])
    dev = mesh.device
    for k in list(LaunchLog(dev).counters.values()) + [calib_nll.KERNEL]:
        k.launches = 0
    t0 = time.perf_counter()
    a = job["spec"]["runs"]["bf16"]
    grad_gap = model_grad_check(mesh, (a["batch"][0] * a["batch"][1], a["cfg"].d_model))
    res = tp_train_runs(dev, job["spec"], mesh, out_dir, names=("uncut", "bf16", "f32", "moe"),
                        store=job["store"])
    res.update(model_grad=grad_gap, rank=torch.distributed.get_rank(), coords=(mesh.coordinate("data"),
                                                           mesh.coordinate("model")),
               mesh=mesh.shape, backend=backend, device=str(dev),
               card=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               seconds=time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank{res['rank']}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def one_rank_store(one, spec, world):
    """A `OneRankStore` of the one-rank training runs' held gradients and
    params (taken out of `one`), with ``job``: what the ranks are handed
    (its ticket, and each run's per-step max|g| by leaf)."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training.loop import whole_specs

    trees, by_path, tops = {}, {}, {}
    for name, r in one["runs"].items():
        if "grads" not in r:
            continue
        for t, tree in enumerate(r.pop("grads")):
            trees[(name, "grads", t)] = tree
        trees[(name, "params")] = r.pop("params")
        by_path[name] = whole_specs(spec["runs"][name]["cfg"], make_debug_mesh(1, world))
        tops[name] = r["grad_tops"]
    store = OneRankStore(trees, by_path, world)
    store.job = {"ticket": store.ticket(), "tops": tops}
    return store


def same_metrics(one, reps, name, rel=None):
    """Every rank's per-step metrics of run `name` against one rank's:
    within `rel` relative (bf16), else rtol / atol 2e-4; returns the
    worst gap."""
    worst = 0.0
    for p in reps:
        for t, (g, w) in enumerate(zip(p["runs"][name]["metrics"],
                                       one["runs"][name]["metrics"])):
            assert sorted(g) == sorted(w), (name, sorted(g), sorted(w))
            for k in w:
                gap = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                if k != "moe_aux" or w[k]:
                    worst = max(worst, gap)
                if rel is not None:
                    assert gap <= rel, f"{name} step {t} {k}: rel {gap:.3g} > {rel:.3g}"
                else:
                    np.testing.assert_allclose(g[k], w[k], err_msg=f"{name} {t} {k}",
                                               rtol=2e-4, atol=2e-4)
    return worst


def held_line(one, reps, name, steps):
    """The ranks' `HeldToOneRank` results of run `name`, summed: the open
    elements held to OPEN_SHARE_MAX of the model; returns the log line's
    text (gradients, then params)."""
    n_all = one["runs"][name]["scalars"]
    where = {}
    for p in reps:
        for path, n in p["runs"][name]["held"][3].items():
            where[path] = where.get(path, 0) + n
    n_open = sum(where.values())
    top = sorted(where.items(), key=lambda kv: -kv[1])
    assert n_open <= OPEN_SHARE_MAX * n_all, (
        f"{name}: {n_open} of {n_all} elements open, more than {OPEN_SHARE_MAX:g} of them "
        f"({top[:6]})")
    p_gap = max(p["runs"][name]["held"][0] for p in reps)
    n_out = sum(p["runs"][name]["held"][1] for p in reps)
    w_out = max(p["runs"][name]["held"][2] for p in reps)
    gaps = [{path: max(p["runs"][name]["grad_gaps"][t][path] for p in reps)
             for path in reps[0]["runs"][name]["grad_gaps"][t]} for t in range(steps)]
    noise = one["runs"][name]["grad_noise"]
    first = sorted(gaps[0], key=lambda k: -gaps[0][k])
    lr_sum = one["runs"][name]["lr_sum"]
    fetch = max(p["runs"][name]["fetch_s"] for p in reps)
    return (f"each step's gradients within {[float(f'{max(g.values()):.3g}') for g in gaps]} "
            f"of max|g| by step (rtol 2e-4, atol 2e-4 max|g|, each rank against its slices of "
            f"one rank's, fetched from this process in {fetch:.1f} s at most); step 1 by leaf, "
            f"the ranks' gap (one rank's step again; with every param one ulp off): "
            + ", ".join(f"{k} {gaps[0][k]:.3g} ({noise['repeat'][k]:.3g}; {noise['ulp'][k]:.3g})"
                        for k in first[:5])
            + f"; the largest of the leaves one rank's step again "
            f"{max(noise['repeat'].values()):.3g}, with the params one ulp off "
            f"{max(noise['ulp'].values()):.3g}; the params after "
            f"{'the step' if steps == 1 else f'the {steps} steps'} within {p_gap:.3g} abs "
            f"(rtol / atol 2e-4) on every element whose gradient stayed within rel "
            f"{ADAM_RHO:g} of one rank's at each step (Adam's update then within "
            f"{2.002 * ADAM_RHO / (1 - ADAM_RHO):.4g} sum(lr)); open {n_open} of {n_all} "
            f"({n_open / n_all:.3g}, at most {OPEN_SHARE_MAX:g}): "
            + (", ".join(f"{p} {n}" for p, n in top[:4]) or "none")
            + f"; {n_out} of them past 2e-4, by up to {w_out:.3g} (allowed "
            f"{2.002 * lr_sum:.3g} more)")


def train_line(one, reps, name):
    r0, w0 = reps[0]["runs"][name], one["runs"][name]
    return (f"steps ms one rank {ms3(w0['ms'])}, per rank "
            f"{[ms3(p['runs'][name]['ms']) for p in reps]}; peak per rank "
            f"{[gb(p['runs'][name]['peak']) for p in reps]} (one rank {gb(w0['peak'])}); "
            f"{r0['scalars']} scalars a rank of {w0['scalars']}")


def train_shares(r):
    s = r["share"]
    return (f"a synced step's forward and backward {s['ms']:.1f} ms: " + ", ".join(
        f"{p} {d['n']} all-reduces of {d['gb']:.3f} GB in {d['ms']:.1f} ms "
        f"({d['ms'] / s['ms']:.1%})" for p, d in s["passes"].items() if d["n"]))


def bf16_train_line(one, reps, name, spec):
    """Run (a) of phase 16 and its phase 17 counterpart: a bf16 model's
    losses and grad_norm held to one rank within `bf16_tp_train_bound`."""
    cfg, run = spec["runs"][name]["cfg"], spec["runs"][name]
    m0 = one["runs"][name]["metrics"]
    ce = min(v for m in m0 for k, v in m.items() if k.startswith("loss_"))
    zmax = one["runs"][name]["zmax"]
    bound = bf16_tp_train_bound(cfg, max(zmax), ce)
    gap = same_metrics(one, reps, name, bound)
    return (f"{run['steps']} remat steps at {run['batch'][0]} x {run['batch'][1]}: losses "
            f"and grad_norm per step within rel {gap:.3g} of one rank (the derived bound "
            f"{bf16_roundings(cfg)} 2u max(1, 2 max|z| / loss) = {bound:.4g}, with max|z| of one "
            f"rank's heads "
            f"{[round(z, 4) for z in zmax]} before and after the steps and its least head loss "
            f"{ce:.4f}); one rank's loss {[round(m['loss'], 4) for m in m0]}, grad_norm "
            f"{[round(m['grad_norm'], 4) for m in m0]}; " + train_line(one, reps, name) + "; "
            + train_shares(reps[0]["runs"][name]))


def served_lines(reps, name, spec, say, tag="d"):
    """Run (d) of phase 16 and its phase 17 counterpart (`tag`): the trained
    model calibrated and served over the mesh (`calibrate_and_serve`),
    every rank's decisions one device's."""
    d0 = reps[0]["runs"][name]["serve"]
    for p in reps[1:]:  # every rank returns one device's decisions
        for key, d in p["runs"][name]["serve"]["plans"].items():
            for level, e in d["engine"].items():
                np.testing.assert_array_equal(
                    e["on_device"], d0["plans"][key]["engine"][level]["on_device"])
    say(f"{tag}. {name}: the eval step's whole-vocab exit logits of {spec['val'][0]} x "
        f"{spec['val'][1]} validation tokens in {d0['eval_ms']:.1f} ms; K2 fit (T, plain T, "
        f"NLLs) {[tuple(round(v, 6) for v in f) for f in d0['fits']]}; planted T* = 1.5: "
        f"K2 {d0['planted'][0]:.6f}, plain {d0['planted'][1]:.6f}", timed=True)
    for key, d in d0["plans"].items():
        one_r = d["one_rank"]
        say(f"{tag}. {name}, plan of the {key} temperatures "
            f"{[round(t, 6) for t in d['temperatures']]}, p_tar {d['p_tar']:.9g}: lm_engine "
            f"over the mesh " + ", ".join(
                f"level {lv} {e['ms']:.1f} ms, {e['offloaded']} offloaded, "
                f"{e['payload_bytes']} payload bytes" for lv, e in d["engine"].items())
            + f"; rank 0 serving the same weights gathered whole on one rank: exit-0 "
            f"confidences within rel {one_r['conf_gap']:.3g} of the mesh's (bound "
            f"{one_r['conf_bound']:.3g}), decisions equal on the {one_r['clear']} of "
            f"{one_r['rows']} rows away from p_tar +- 1e-6 (on every row: "
            f"{one_r['equal']}), ms {[round(v, 1) for v in one_r['ms'].values()]}",
            timed=True)


def clear_files(out_dir):
    """Remove a phase's large files: the ranks' checkpoints."""
    for f in os.listdir(out_dir):
        if f.endswith((".pt", ".msgpack")):
            os.remove(os.path.join(out_dir, f))


def tp_train_phase(dev, spec, out_dir, timeout=900, say=print, world=None):
    """Phase 16: LM training with the parameters split over a model axis of
    W ranks (each a process of this script under ``--tp-train``,
    `tp_train_rank_main`, `launch_ranks`; W and the
    backend as `rank_world` picks them), then the trained model calibrated
    and served on the same mesh; the mesh is (data 1, model W). The same
    training runs first on one rank in this process (`tp_train_runs`; its
    launches kept out of the phase's counts; its memory freed before the
    ranks start), and each rank is held to it: (a) the bf16 losses and
    grad_norm per step within `bf16_tp_train_bound`, and its reduces on
    their own (`wide_mm_check` here, `model_grad_check` in the ranks); (b)
    the float32 twin's losses and grad_norm, every gradient leaf at every
    step and its parameters after 3 steps, each rank against its slices of
    the one-rank run's (`OneRankStore`, `HeldToOneRank`), its checkpoint one
    device's file, reloaded bit for bit; (c) the MoE step's metrics,
    gradients and parameters the same way, its dropped counts per layer
    equal. Run (d) is held within the ranks (`calibrate_and_serve`).
    `world` sets W for a rehearsal on the CPU. Returns the K1-K4 launches
    summed over the ranks."""
    from repro_torch.kernels import calib_nll

    w_, backend = rank_world(dev)
    world = world or w_
    os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    counters = list(LaunchLog(dev).counters.values()) + [calib_nll.KERNEL]
    before = [k.launches for k in counters]
    one = tp_train_runs(dev, spec, None, out_dir)
    for k, n in zip(counters, before):
        k.launches = n
    say(f"one rank in this process, {time.perf_counter() - t0:.2f} s: " + "; ".join(
        f"{n} {r['scalars']} scalars, steps {ms3(r['ms'])} ms, peak {gb(r['peak'])}, "
        f"{r['seconds']:.2f} s" for n, r in one["runs"].items()), timed=True)
    a = spec["runs"]["bf16"]
    wide = (wide_mm_check(dev, a["cfg"], a["batch"][0] * a["batch"][1], world)
            if dev.type == "cuda" else None)
    store = one_rank_store(one, spec, world)
    try:
        reps, wall, _ = launch_ranks("--tp-train", out_dir, world,
                                     {"spec": spec, "model": world, "store": store.job},
                                     timeout)
    finally:
        store.close()
    clear_files(out_dir)
    say(f"{world} ranks over {backend}, mesh (data 1, model {world}) (processes "
        f"of this script with torch.distributed.run's rank environment, `launch_ranks`), "
        f"{wall:.2f} s from "
        f"launch to exit: " + "; ".join(
            f"rank {p['rank']} on {p['device']} ({p['card']}, {p['backend']}), its runs "
            f"{p['seconds']:.2f} s (" + ", ".join(
                f"{n} {r['train_s']:.1f} s training, {r['seconds']:.1f} s in all"
                for n, r in p["runs"].items()) + ")" for p in reps), timed=True)
    check_reps(reps, world, backend)
    runs = spec["runs"]
    hold = "cuda" if dev.type == "cuda" else "cpu"

    # (a) bf16
    cfg = runs["bf16"]["cfg"]
    rows = runs["bf16"]["batch"][0] * runs["bf16"]["batch"][1]
    say(f"a. {cfg.name} widths (d {cfg.d_model}, {cfg.num_heads} heads, kv "
        f"{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) reduced to "
        f"{cfg.num_layers} layers, exits {cfg.exit_layers}, bf16, "
        + bf16_train_line(one, reps, "bf16", spec), timed=True)
    say(f"a. the bf16 reduces on {hold}: model_grad's backward at ({rows}, {cfg.d_model}) the "
        f"float32 sum of the ranks' gradients rounded once"
        + (" (bit for bit)" if world == 2 else "") + ", worst gap over its bound "
        f"{max(p['model_grad'] for p in reps):.3g}; " + ("; ".join(
            f"_WideMM {leaf} {v['shape']}: forward {v['fwd']:.3g} of K 2^-24 (|x| @ |w|), "
            f"input and weight gradients bit for bit one device's bf16 product (to float64 "
            f"{v['dx']:.3g}, {v['dw']:.3g} of max)" for leaf, v in wide.items())
            if wide is not None else "_WideMM not run (the card's float32-output GEMM only)"),
        timed=True)

    # (b) the float32 twin
    cfg = runs["f32"]["cfg"]
    gap = same_metrics(one, reps, "f32")
    r0 = reps[0]["runs"]["f32"]
    assert all(p["runs"]["f32"]["ckpt_back"] for p in reps)
    say(f"b. float32 twin ({cfg.num_layers} layers, exits {cfg.exit_layers}, "
        f"{runs['f32']['batch'][0]} x {runs['f32']['batch'][1]}, {runs['f32']['steps']} steps): "
        f"losses and grad_norm within rel {gap:.3g}; "
        + held_line(one, reps, "f32", runs["f32"]["steps"])
        + f"; the ranks' checkpoint, one device's layout, written in {r0['ckpt_save_s']:.2f} s "
        f"and reloaded bit for bit on every rank; {r0['replicated_equal']} replicated elements "
        f"bit-equal over the ranks; " + train_line(one, reps, "f32"), timed=True)

    # (c) the MoE step
    cfg = runs["moe"]["cfg"]
    gap = same_metrics(one, reps, "moe")
    w0, r0 = one["runs"]["moe"], reps[0]["runs"]["moe"]
    assert sum(w0["dropped"]) > 0, "no token dropped: the MoE check needs drops"
    for p in reps:
        assert p["runs"]["moe"]["dropped"] == w0["dropped"], (p["runs"]["moe"]["dropped"],
                                                              w0["dropped"])
    say(f"c. {cfg.name} widths ({cfg.moe_num_experts} experts top-{cfg.moe_top_k}, "
        f"{cfg.moe_num_experts // world} a rank) reduced to {cfg.num_layers} layers, capacity "
        f"factor {cfg.moe_capacity_factor}, float32, one step at {runs['moe']['batch'][0]} x "
        f"{runs['moe']['batch'][1]}: dropped (token, slot) pairs per layer {r0['dropped']} on "
        f"every rank, as on one; metrics within rel {gap:.3g}; "
        + held_line(one, reps, "moe", runs["moe"]["steps"]) + "; " + train_line(one, reps, "moe"),
        timed=True)

    # (d) the trained model, calibrated and served over the mesh
    if "uncut" in runs:
        cfg, r0 = runs["uncut"]["cfg"], reps[0]["runs"]["uncut"]
        b, s = runs["uncut"]["batch"]
        for p in reps:
            u = p["runs"]["uncut"]
            assert u["scalars"] * world >= cfg.param_count(), (u["scalars"], cfg.param_count())
            assert all(np.isfinite(m["loss"]) for m in u["metrics"])
        say(f"{cfg.name} uncut ({cfg.num_layers} layers, param_count {cfg.param_count()}), "
            f"bf16, {runs['uncut']['steps']} remat steps at {b} x {s}: "
            f"{[p['runs']['uncut']['scalars'] for p in reps]} scalars a rank; losses "
            f"{[round(m['loss'], 4) for m in r0['metrics']]}, grad_norm "
            f"{[round(m['grad_norm'], 4) for m in r0['metrics']]}; steps ms per rank "
            f"{[ms3(p['runs']['uncut']['ms']) for p in reps]}; peak per rank "
            f"{[gb(p['runs']['uncut']['peak']) for p in reps]}; " + train_shares(r0), timed=True)
    for name in ("bf16", "uncut"):
        if "levels" in runs.get(name, {}):
            served_lines(reps, name, spec, say)
    say("launches per rank (K1, K3, K4, K2): " + "; ".join(
        f"rank {p['rank']} {tuple(p['launches'].values())}" for p in reps))
    return summed_launches(reps)


# ------------------------------------------------------------ tp_ssm (17)
def tp_ssm_spec(full=True, uncut=False):
    """Phase 17's runs: serving runs (`tp_runs`: a config, prefill (b, s),
    decode steps, lm_engine's codec levels) and training runs
    (`tp_train_runs`: a config, (batch, seq), steps, flags) of the mamba and
    hybrid families, at their published widths (`full`), or a CPU
    rehearsal of the same runs on smoke widths. With `uncut`, also
    jamba-v0.1-52b served at its published 32 layers, which only a mesh of
    four cards holds (`tools/tp_phase.py --ssm`)."""
    from repro_torch.configs import get_config, get_smoke

    if full:
        m, j = get_config("mamba2-130m"), get_config("jamba-v0.1-52b")
        f32 = m.replace(dtype="float32")
        # reduced: 32 -> 8 layers, one period (7 mamba + 1 attention, 4
        # MoE), the exits (7, 15) -> (3,), as phase 12 cuts it
        j8 = j.replace(num_layers=8, exit_layers=(3,), exit_loss_weights=(1.0,))
        # reduced: 32 -> 2 layers (mamba + dense MLP, mamba + MoE), the
        # exits (7, 15) -> (0,)
        j2 = j.replace(num_layers=2, exit_layers=(0,), exit_loss_weights=(1.0,))
        serve = {"ssm_bf16": dict(cfg=m, serve=(8, 512), decode=16, levels=(0, 2)),
                 "ssm_f32": dict(cfg=f32, serve=(4, 256), decode=4, levels=()),
                 "jamba": dict(cfg=j8, serve=(8, 512), decode=8, levels=(0, 2)),
                 # reduced: 32 -> 5 layers (mamba + MLP, mamba + MoE twice, then
                 # attention + MLP), exits -> (0,), float32, where routes and
                 # drops must be one rank's: the check with teeth of (c)
                 "jamba_f32": dict(cfg=j.replace(num_layers=5, exit_layers=(0,),
                                                 exit_loss_weights=(1.0,), dtype="float32"),
                                   serve=(4, 256), decode=4, levels=())}
        train = {"ssm_bf16": dict(cfg=m, batch=(8, 512), steps=3, **BF16_RUN),
                 "ssm_f32": dict(cfg=f32, batch=(4, 256), steps=3, levels=(0, 2), **F32_RUN),
                 "jamba": dict(cfg=j2, batch=(4, 512), steps=1, **BF16_RUN)}
        if uncut:
            serve["uncut"] = dict(cfg=j, serve=(8, 512), decode=32, levels=(0, 1, 2))
        return dict(device=None, serve=dict(device=None, runs=serve),
                    train=dict(device=None, runs=train, val=(8, 128), serve=(8, 512)))
    m = get_smoke("mamba2-130m").replace(num_layers=4, exit_layers=(0, 2),
                                         exit_loss_weights=(1.0, 1.0))
    j = get_smoke("jamba-v0.1-52b").replace(num_layers=4, exit_layers=(1,),
                                            moe_capacity_factor=0.5)
    serve = {"ssm_bf16": dict(cfg=m, serve=(4, 32), decode=4, levels=(0, 2)),
             "ssm_f32": dict(cfg=m.replace(dtype="float32"), serve=(2, 32), decode=2,
                             levels=()),
             "jamba": dict(cfg=j, serve=(4, 32), decode=2, levels=(0, 2)),
             "jamba_f32": dict(cfg=j.replace(num_layers=2, exit_layers=(0,), dtype="float32"),
                               serve=(2, 32), decode=2, levels=())}
    train = {"ssm_bf16": dict(cfg=m, batch=(4, 32), steps=3, **BF16_RUN),
             "ssm_f32": dict(cfg=m.replace(dtype="float32"), batch=(4, 32), steps=3,
                             levels=(0, 2), **F32_RUN),
             "jamba": dict(cfg=j.replace(num_layers=2, exit_layers=(0,)), batch=(4, 32),
                           steps=1, **BF16_RUN)}
    if uncut:
        serve["uncut"] = dict(cfg=j.replace(num_layers=6, exit_layers=(1, 3),
                                            exit_loss_weights=(1.0, 1.0)),
                              serve=(4, 32), decode=4, levels=(0, 1, 2))
    return dict(device="cpu", serve=dict(device="cpu", runs=serve),
                train=dict(device="cpu", runs=train, val=(4, 32), serve=(4, 32)))


def run_tokens(run):
    """The tokens of a training run's batch."""
    return run["batch"][0] * run["batch"][1]


SSM_SERVE = ("ssm_bf16", "ssm_f32", "jamba", "jamba_f32")
SSM_TRAIN = ("ssm_bf16", "ssm_f32", "jamba")


def tp_model_rank_main(out_dir) -> int:
    """One rank of phase 17 or 18 (`launch_ranks`): `tp_runs`
    and then `tp_train_runs` of the job's runs (its ``names``, serving and
    training) over the (data 1, model W) mesh, the kernels' launches
    counted from 0. Writes rank<r>.pkl to `out_dir`."""
    import pickle

    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import calib_nll
    from repro_torch.launch.mesh import join_ranks

    with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    entered = time.time() - job["launched"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, backend = join_ranks(job["spec"]["device"], model=job["model"])
    dev = mesh.device
    for k in list(LaunchLog(dev).counters.values()) + [calib_nll.KERNEL]:
        k.launches = 0
    joined = time.time() - job["launched"]
    t0 = time.perf_counter()
    serve_names, train_names = job["names"]
    serve = tp_runs(dev, job["spec"]["serve"], mesh, job["p_tar"], names=serve_names,
                    plans=job.get("plans"))
    t_serve = time.perf_counter() - t0
    train = tp_train_runs(dev, job["spec"]["train"], mesh, out_dir, names=train_names,
                          store=job["store"])
    res = dict(serve=serve, train=train, launches={**serve["launches"], **train["launches"]},
               rank=torch.distributed.get_rank(),
               coords=(mesh.coordinate("data"), mesh.coordinate("model")), mesh=mesh.shape,
               backend=backend, device=str(dev),
               card=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               serve_s=t_serve, seconds=time.perf_counter() - t0, started=(entered, joined))
    with open(os.path.join(out_dir, f"rank{res['rank']}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def serving_line(one_s, sv, runs_s, flops, world, name, bound):
    """Phase 17's and 18's line for serving run `name` over the ranks `sv`
    against one rank `one_s` (`held_serving`; `bound` None holds it at rtol /
    atol 2e-4), with its sizes, times, the all-reduces' share and peaks;
    `flops` the dry run's FLOPs of the prefills it has them for."""
    gap, n, unheld, carried = held_serving(one_s, sv, name, bound)
    cfg, r0, w0 = runs_s[name]["cfg"], sv[0]["runs"][name], one_s["runs"][name]
    b, s = runs_s[name]["serve"]
    rate = (f" ({flops[name]:.4g} FLOPs, {flops[name] / (min(r0['ms']) * 1e-3) / 1e12:.1f} "
            f"TFLOP/s over the {world} ranks)" if name in flops else "")
    steps = 1 + len(w0.get("decode", []))
    drops = ("" if "dropped" not in r0 else
             f"; dropped (token, slot) pairs per layer {r0['dropped']} on rank 0, one rank "
             f"{w0['dropped']}" + (
                 "" if bound is None else
                 f"; (row, step) pairs whose compared token a rank routed otherwise than "
                 f"one rank (held to finite values only): {unheld} of {len(sv) * b * steps} "
                 f"over the ranks; the worst gap held where only an earlier token of the "
                 f"row was rerouted rel {carried:.3g} of max|z|"))
    held = len(sv) * b * steps - unheld
    tol = (f"within rel {gap:.3g} of max|z| of one rank on the {held} (row, step) pairs held "
           f"(the derived bound {bf16_roundings(cfg)} 2u = {bound:.4g})" if bound else
           f"within rel {gap:.3g} (rtol / atol 2e-4)")
    return (f"serving, {r0['scalars']} scalars a rank of {w0['scalars']}: prefill {b} x {s}, "
            f"{len(r0.get('decode', []))} decode steps from its caches"
            + (f", lm_engine at levels {tuple(r0['engine'])}" if r0["engine"] else "")
            + f": every rank {tol}; {n} predictions and decisions equal "
            f"where one rank's margins clear it; the last token's logits against a prefill "
            f"over the same tokens rel {r0['resume_gap']:.3g}{drops}; prefill ms one rank "
            f"{ms3(w0['ms'])}, rank 0 {ms3(r0['ms'])}{rate}; decode ms a token one rank "
            f"{ms3(w0['decode_ms'])}, rank 0 {ms3(r0['decode_ms'])}; {serve_shares(r0)}"
            + (f"; lm_engine one rank {engine_line(w0)}; rank 0 {engine_line(r0)}"
               if r0["engine"] else "")
            + f"; peak per rank {[gb(p['runs'][name]['peak']) for p in sv]} (one rank "
            f"{gb(w0['peak'])})")


def tp_ssm_phase(dev, spec, out_dir, timeout=900, say=print):
    """Phase 17: the mamba and hybrid families with their parameters split
    over a model axis of W ranks (each a process of this script under
    ``--tp-ssm``, `tp_model_rank_main`, `launch_ranks`; W and the backend as `rank_world` picks them); the
    mesh is (data 1, model W), each mamba layer on its block of SSD heads
    with B and C whole (`sharding.layout_specs`). The same runs first on
    one rank in this process (their launches kept out of the phase's
    counts, their memory freed before the ranks start), and each rank is
    held to them: (a) mamba2-130m uncut, bf16: prefill, decode from its
    caches and lm_engine within `bf16_tp_bound` (`held_serving`), 3 remat
    steps' losses and grad_norm within `bf16_tp_train_bound`; (b) its
    float32 twin: prefill and decode at rtol / atol 2e-4, every gradient
    leaf at every step and the params after 3 steps against the one-rank
    run's (`HeldToOneRank`), every element held whole bit-equal over the
    ranks, the ranks' checkpoint one device's file, then the trained model
    calibrated (K2 against the plain fit, on planted labels too) and served
    over the mesh (`calibrate_and_serve`); (c) jamba-v0.1-52b's widths
    reduced to 8 layers, bf16: prefill, decode and lm_engine within
    `bf16_tp_bound` where a rank routed the compared token as one rank did
    (`held_serving`: the other pairs finite, each layer's dropped count
    within its rerouted tokens), and reduced to 5 layers (mamba with the
    dense MLP and the MoE, then attention) in float32, at rtol / atol 2e-4
    with dropped counts equal; (d) jamba reduced to 2 layers: one bf16
    remat step held as (a), each dropped count within its rerouted tokens
    of one rank's. With the
    ``uncut`` run (four cards), jamba-v0.1-52b uncut is served over the
    mesh beside the dry run's peak of its prefill as rank 0 of the mesh.
    Returns the K1-K4 launches summed over the ranks."""
    from repro_torch.kernels import calib_nll

    world, backend = rank_world(dev)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    counters = list(LaunchLog(dev).counters.values()) + [calib_nll.KERNEL]
    before = [k.launches for k in counters]
    one_s = tp_runs(dev, spec["serve"], None, names=SSM_SERVE)
    t_serve = time.perf_counter() - t0
    one_t = tp_train_runs(dev, spec["train"], None, out_dir, names=SSM_TRAIN)
    for k, n in zip(counters, before):
        k.launches = n
    say(f"one rank in this process, {t_serve:.2f} s serving: " + "; ".join(
        f"{n} {r['scalars']} scalars, prefill {ms3(r['ms'])} ms, peak {gb(r['peak'])}"
        for n, r in one_s["runs"].items()) + f"; {time.perf_counter() - t0 - t_serve:.2f} s "
        f"training: " + "; ".join(
        f"{n} {r['scalars']} scalars, steps {ms3(r['ms'])} ms, peak {gb(r['peak'])}"
        for n, r in one_t["runs"].items()), timed=True)
    store = one_rank_store(one_t, spec["train"], world)
    runs_s, runs_t = spec["serve"]["runs"], spec["train"]["runs"]

    def costs():  # the dry run's FLOPs, and the uncut model's peak as rank 0
        out = {n: prefill_cost(r["cfg"], *r["serve"])["flops"] for n, r in runs_s.items()
               if n in ("ssm_bf16", "jamba", "uncut")}
        if "uncut" in runs_s:
            out["uncut_peak"] = prefill_cost(runs_s["uncut"]["cfg"], *runs_s["uncut"]["serve"],
                                             model=world)["peak_bytes"]
        return out

    try:
        reps, wall, flops = launch_ranks(
            "--tp-ssm", out_dir, world, {"spec": spec, "p_tar": one_s["p_tar"],
                                         "store": store.job, "model": world,
                                         "names": (("uncut",) + SSM_SERVE, SSM_TRAIN)},
            timeout,
            meanwhile=costs)
    finally:
        store.close()
    clear_files(out_dir)
    say(f"{world} ranks over {backend}, mesh (data 1, model {world}) (processes "
        f"of this script with torch.distributed.run's rank environment, `launch_ranks`), "
        f"{wall:.2f} s from "
        f"launch to exit: " + "; ".join(
            f"rank {p['rank']} on {p['device']} ({p['card']}, {p['backend']}), its runs "
            f"{p['seconds']:.2f} s ({p['serve_s']:.1f} s serving)" for p in reps), timed=True)
    check_reps(reps, world, backend)
    sv = [dict(p["serve"], rank=p["rank"], coords=p["coords"]) for p in reps]
    tr = [dict(p["train"], rank=p["rank"], coords=p["coords"]) for p in reps]

    def serving(name, bound):
        return serving_line(one_s, sv, runs_s, flops, world, name, bound)

    cfg = runs_s["ssm_bf16"]["cfg"]
    say(f"a. {cfg.name} uncut ({cfg.num_layers} layers, d {cfg.d_model}, {cfg.ssm_heads} SSD "
        f"heads, {cfg.ssm_heads // world} a rank, state {cfg.ssm_state}, vocab "
        f"{cfg.vocab_size}), bf16: " + serving("ssm_bf16", bf16_tp_bound(cfg)),
        timed=True)
    say(f"a. {cfg.name} training: " + bf16_train_line(one_t, tr, "ssm_bf16", spec["train"]),
        timed=True)
    cfg = runs_s["ssm_f32"]["cfg"]
    say(f"b. {cfg.name} float32 twin, uncut: " + serving("ssm_f32", None), timed=True)
    run = runs_t["ssm_f32"]
    gap = same_metrics(one_t, tr, "ssm_f32")
    r0 = tr[0]["runs"]["ssm_f32"]
    assert all(p["runs"]["ssm_f32"]["ckpt_back"] for p in tr)
    say(f"b. float32 twin training, {run['steps']} steps at {run['batch'][0]} x "
        f"{run['batch'][1]}: losses and grad_norm within rel {gap:.3g}; "
        + held_line(one_t, tr, "ssm_f32", run["steps"])
        + f"; {r0['replicated_equal']} elements held whole (the B and C columns of in_proj and "
        f"channels of conv_w / conv_b, the norms) bit-equal over the ranks; the ranks' "
        f"checkpoint, one device's layout, written in {r0['ckpt_save_s']:.2f} s and reloaded "
        f"bit for bit on every rank; " + train_line(one_t, tr, "ssm_f32"), timed=True)
    served_lines(tr, "ssm_f32", spec["train"], say, tag="b")
    cfg = runs_s["jamba"]["cfg"]
    say(f"c. {cfg.name} widths (d {cfg.d_model}, {cfg.ssm_heads} SSD heads, {cfg.num_heads} "
        f"heads, kv {cfg.num_kv_heads}, {cfg.moe_num_experts} experts top-{cfg.moe_top_k}) "
        f"reduced to {cfg.num_layers} layers, exits {cfg.exit_layers}, bf16: "
        + serving("jamba", bf16_tp_bound(cfg)), timed=True)
    cfg = runs_s["jamba_f32"]["cfg"]
    say(f"c. {cfg.name} widths reduced to {cfg.num_layers} layers ({cfg.layer_plan()}), exits "
        f"{cfg.exit_layers}, float32: " + serving("jamba_f32", None), timed=True)
    cfg = runs_t["jamba"]["cfg"]
    w0 = one_t["runs"]["jamba"]
    moved = []
    for p in tr:  # each MoE layer's dropped count within its rerouted tokens of one rank's
        got = p["runs"]["jamba"]
        flips = [int((g != w).any(-1).sum()) for g, w in zip(got["routes"], w0["routes"])]
        assert all(abs(g - w) <= f for g, w, f in zip(got["dropped"], w0["dropped"], flips)), (
            got["dropped"], w0["dropped"], flips)
        moved.append(flips)
    say(f"d. {cfg.name} widths reduced to {cfg.num_layers} layers ({cfg.layer_plan()}), exits "
        f"{cfg.exit_layers}, bf16: dropped (token, slot) pairs per MoE layer one rank "
        f"{w0['dropped']}, per rank "
        f"{[p['runs']['jamba']['dropped'] for p in tr]}, each within the tokens a rank routed "
        f"otherwise than one rank ({moved} of {run_tokens(runs_t['jamba'])} a layer); "
        + bf16_train_line(one_t, tr, "jamba", spec["train"]), timed=True)
    if "uncut" in runs_s:
        say("e. " + uncut_serving_line(
            runs_s["uncut"]["cfg"], runs_s["uncut"]["serve"], sv[0]["runs"]["uncut"], sv, world,
            flops["uncut"], extra=f" (the dry run's peak of the prefill as rank 0 of (data 1, "
            f"model {world}): {flops['uncut_peak'] / 1e9:.2f} GB)"), timed=True)
    say("launches per rank (K1, K3, K4, K2): " + "; ".join(
        f"rank {p['rank']} {tuple(p['launches'].values())}" for p in reps))
    return summed_launches(reps)


# ------------------------------------------------------------ tp_enc_dec (18)
ENC_DEC = ("enc_bf16", "enc_f32")


def tp_enc_dec_spec(full=True):
    """Phase 18's runs: serving runs (`tp_runs`) and training runs
    (`tp_train_runs`) of whisper-base uncut, bf16 and its float32 twin, at
    its published widths (`full`), or a CPU rehearsal of the same runs on
    its smoke widths. The twin's serving run is also calibrated and served
    under its plan (``calib``: the validation and serving batches)."""
    from repro_torch.configs import get_config, get_smoke

    w = get_config("whisper-base") if full else get_smoke("whisper-base")
    f32 = w.replace(dtype="float32")
    if full:
        # reduced for the script's time (PERF.md §4): the bf16 run's batch 8
        # -> 4 (frames (4, 1500, 512)) and its decode 16 -> 8 tokens; the
        # twin's batches 4 -> 2 and its serving 8 -> 4
        serve = {"enc_bf16": dict(cfg=w, serve=(4, 448), decode=8, levels=()),
                 "enc_f32": dict(cfg=f32, serve=(2, 64), decode=4, levels=(),
                                 calib=dict(val=(2, 64), serve=(4, 64)))}
        train = {"enc_bf16": dict(cfg=w, batch=(4, 128), steps=3, **BF16_RUN),
                 "enc_f32": dict(cfg=f32, batch=(2, 64), steps=3, **F32_RUN)}
        return dict(device=None, serve=dict(device=None, runs=serve),
                    train=dict(device=None, runs=train))
    serve = {"enc_bf16": dict(cfg=w, serve=(4, 32), decode=4, levels=()),
             "enc_f32": dict(cfg=f32, serve=(2, 16), decode=2, levels=(),
                             calib=dict(val=(4, 16), serve=(8, 16)))}
    train = {"enc_bf16": dict(cfg=w, batch=(4, 32), steps=3, **BF16_RUN),
             "enc_f32": dict(cfg=f32, batch=(4, 16), steps=3, **F32_RUN)}
    return dict(device="cpu", serve=dict(device="cpu", runs=serve),
                train=dict(device="cpu", runs=train))


def calibrate_served(dev, name, cfg, params, calib, mesh, log, plans):
    """Phase 18's run (c) on a served model over `mesh` (None: one rank):
    the eval step's whole-vocab exit logits of a seeded validation batch
    (``calib["val"]`` (b, s), its frames `enc_frames`), gathered over the
    mesh; each exit's temperature fit by K2 on them (from the best point of
    `K2_GRID`) and by the plain fit, held to each other (by T or by NLL, as
    phase 12), and exit 0's on labels planted at T* = 1.5 (by T, as phase
    11); then an `OffloadPlan` served through ``make_prefill_step(plan=)``
    on a seeded batch (``calib["serve"]``): on one rank the plan of its K2
    temperatures, exit 0's the planted fit (its confidences spread over
    (0, 1)), stored in `plans`; over a mesh the plan `plans` holds, one
    rank's, so the served confidences are held to one rank's. Returns the
    fits and the served confidences and predictions (and, on one rank, the
    exits' logits, whose margins decide which rows must agree)."""
    import torch

    from repro_torch.core.calibration import TemperatureScaling
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import registry

    n_ex = len(cfg.exit_layers)
    out = fit_exits(dev, name, cfg, params, calib["val"], mesh, log)
    if mesh is None:
        plans[name] = [out["planted"][0]] + [f[0] for f in out["fits"][1:]]
    plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(t)
                                               for t in plans[name]])
    batch = model_inputs(tp_train_batches(cfg, calib["serve"], 1, seed=6)[0])
    before = log.now()
    t0 = time.perf_counter()
    pre = make_prefill_step(cfg, plan=plan, device=dev, mesh=mesh)(params, batch)
    _sync(dev)
    out["serve_ms"] = 1e3 * (time.perf_counter() - t0)
    log.expect(f"{name} prefill under the calibrated plan", before, exit_gate=n_ex)
    out["conf"] = pre["exit_confidence"].double().cpu().numpy()
    out["pred"] = pre["exit_prediction"].cpu().numpy()
    del pre
    if mesh is None:
        with torch.no_grad():
            zs = registry.forward_prefill(params, cfg, {
                k: torch.as_tensor(v, device=dev) for k, v in batch.items()})["exit_logits"]
        out["exit_logits"] = [z[:, 0].float().cpu().numpy() for z in zs]
    return out


def held_calibration(one, reps, name):
    """Run (c) over the ranks against one rank (`calibrate_served`): each
    exit's K2 temperature on the token labels within rel 2e-4 of one rank's
    (ROADMAP caveat c) or, where the NLL is flat (caveat j), its NLL within
    rel 1e-6; the planted fit within rel 1e-3 (K2 against the plain fit's
    own tolerance); the served plan's confidences at rtol / atol 2e-4, its
    predictions equal where one rank's margins clear 2 (2e-4 (1 + max|z|))
    and its decisions equal away from p_tar +- (the gap + 1e-6), p_tar at
    the widest ratio between two neighbouring exit-0 confidences of one
    rank. Returns (the worst T gap, the worst NLL gap, the worst confidence
    gap, the rows held, p_tar)."""
    want = one["runs"][name]["calib"]
    c0 = np.sort(want["conf"][0])
    i = int(np.argmax(np.log(c0[1:]) - np.log(c0[:-1])))
    p_tar = float(np.sqrt(c0[i] * c0[i + 1]))
    t_gap = n_gap = c_gap = 0.0
    held = 0
    for p in reps:
        got = p["runs"][name]["calib"]
        for g, w in zip(got["fits"], want["fits"]):
            dt, dn = abs(g[0] - w[0]) / w[0], abs(g[2] - w[2]) / abs(w[2])
            assert dt <= 2e-4 or dn <= 1e-6, (name, g, w)
            t_gap, n_gap = max(t_gap, dt), max(n_gap, dn)
        assert abs(got["planted"][0] - want["planted"][0]) <= 1e-3 * want["planted"][0], (
            name, got["planted"], want["planted"])
        np.testing.assert_allclose(got["conf"], want["conf"], rtol=2e-4, atol=2e-4, err_msg=name)
        gap = np.abs(got["conf"] - want["conf"])
        c_gap = max(c_gap, float((gap / want["conf"]).max()))
        for e, z in enumerate(want["exit_logits"]):
            clear = _top2_clear(z, 4e-4 * (1 + float(np.abs(z).max())))
            np.testing.assert_array_equal(got["pred"][e][clear], want["pred"][e][clear])
            held += int(clear.sum())
        clear = np.abs(want["conf"][0] - p_tar) > gap[0] + BOUNDARY
        np.testing.assert_array_equal((got["conf"][0] >= p_tar)[clear],
                                      (want["conf"][0] >= p_tar)[clear], err_msg=name)
        held += int(clear.sum())
    return t_gap, n_gap, c_gap, held, p_tar


def tp_enc_dec_phase(dev, spec, out_dir, timeout=900, say=print):
    """Phase 18: the encoder-decoder (whisper-base) with its parameters
    split over a model axis of W ranks (each a process of this script under
    ``--tp-enc-dec``, `tp_model_rank_main`, `launch_ranks`; W and the backend as `rank_world` picks them); the
    mesh is (data 1, model W): the encoder's, the decoder's and the
    cross-attention's heads and ``d_ff`` split, the vocabulary too where W
    divides it (51 865 it does not: the embedding and heads whole). The same
    runs first on one rank in this process (their launches kept out of the
    phase's counts, their memory freed before the ranks start), and each
    rank is held to them: (a) uncut, bf16, frames (4, 1500, 512): prefill 4
    x 448 and 8 tokens decoded from its caches within `bf16_tp_bound`
    ((2 Le + 3 Ld + 3) 2u of max|z|, `held_serving`: the logits, and the
    exits' predictions and K1 decisions where one rank's margins clear
    it), 3 remat steps at 4 x 128 whose losses and grad_norm stay within
    `bf16_tp_train_bound`; (b) its float32 twin, uncut: prefill and decode
    at rtol / atol 2e-4, 3 steps with every gradient leaf at every step and
    the params after them against the one-rank run's (`HeldToOneRank`),
    every replicated element bit-equal over the ranks, the ranks'
    checkpoint one device's file; (c) the twin calibrated over the mesh and
    a plan served (`calibrate_served`, `held_calibration`). Returns the
    K1-K4 launches summed over the ranks."""
    from repro_torch.kernels import calib_nll

    world, backend = rank_world(dev)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    counters = list(LaunchLog(dev).counters.values()) + [calib_nll.KERNEL]
    before = [k.launches for k in counters]
    one_s = tp_runs(dev, spec["serve"], None, names=ENC_DEC)
    t_serve = time.perf_counter() - t0
    one_t = tp_train_runs(dev, spec["train"], None, out_dir, names=ENC_DEC)
    for k, n in zip(counters, before):
        k.launches = n
    say(f"one rank in this process, {t_serve:.2f} s serving: " + "; ".join(
        f"{n} {r['scalars']} scalars, prefill {ms3(r['ms'])} ms, peak {gb(r['peak'])}"
        for n, r in one_s["runs"].items()) + f"; {time.perf_counter() - t0 - t_serve:.2f} s "
        f"training: " + "; ".join(
        f"{n} steps {ms3(r['ms'])} ms, peak {gb(r['peak'])}"
        for n, r in one_t["runs"].items()), timed=True)
    store = one_rank_store(one_t, spec["train"], world)
    runs_s, runs_t = spec["serve"]["runs"], spec["train"]["runs"]
    try:
        reps, wall, flops = launch_ranks(
            "--tp-enc-dec", out_dir, world, {
                "spec": spec, "p_tar": one_s["p_tar"], "plans": one_s["plans"],
                "store": store.job, "model": world, "names": (ENC_DEC, ENC_DEC)}, timeout,
            meanwhile=lambda: {"enc_bf16": prefill_cost(runs_s["enc_bf16"]["cfg"],
                                                        *runs_s["enc_bf16"]["serve"])["flops"]})
    finally:
        store.close()
    clear_files(out_dir)
    say(f"{world} ranks over {backend}, mesh (data 1, model {world}) (processes "
        f"of this script with torch.distributed.run's rank environment, `launch_ranks`), "
        f"{wall:.2f} s from "
        f"launch to exit: " + "; ".join(
            f"rank {p['rank']} on {p['device']} ({p['card']}, {p['backend']}) in this script "
            f"{p['started'][0]:.1f} s after the launch, joined at {p['started'][1]:.1f} s, its "
            f"runs {p['seconds']:.2f} s ({p['serve_s']:.1f} s serving; " + ", ".join(
                f"{n} {r['train_s']:.1f} s training: set-up {r['setup_s']:.1f} s (the sharded "
                f"init {r['init_ms'] / 1e3:.1f} s), steps with the held gradients "
                f"{r['steps_s']:.1f} s, the replicated check {r['replicated_s']:.1f} s"
                + (f", the gradients and params fetched {r['fetch_s']:.1f} s" if "fetch_s" in r
                   else "")
                + (f", the checkpoint {r['ckpt_s']:.1f} s" if "ckpt_s" in r else "")
                for n, r in p["train"]["runs"].items()) + ")" for p in reps), timed=True)
    check_reps(reps, world, backend)
    sv = [dict(p["serve"], rank=p["rank"], coords=p["coords"]) for p in reps]
    tr = [dict(p["train"], rank=p["rank"], coords=p["coords"]) for p in reps]

    cfg = runs_s["enc_bf16"]["cfg"]
    split = [n for n, width in (("heads", cfg.num_heads), ("d_ff", cfg.d_ff),
                                ("vocab", cfg.vocab_size)) if width % world == 0]
    say(f"a. {cfg.name} uncut ({cfg.encoder_layers} + {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; split "
        f"over {world}: {', '.join(split)}), bf16, frames ({runs_s['enc_bf16']['serve'][0]}, "
        f"{cfg.encoder_seq}, {cfg.d_model}): "
        + serving_line(one_s, sv, runs_s, flops, world, "enc_bf16", bf16_tp_bound(cfg)),
        timed=True)
    w0, p_tar = one_s["runs"]["enc_bf16"], one_s["p_tar"]["enc_bf16"]
    agree = [(float(np.mean(p["runs"]["enc_bf16"]["prefill"]["exit_prediction"]
                            == w0["prefill"]["exit_prediction"])),
              float(np.mean((p["runs"]["enc_bf16"]["prefill"]["exit_confidence"] >= p_tar)
                            == (w0["prefill"]["exit_confidence"] >= p_tar)))) for p in sv]
    say(f"a. the prefill's exit predictions and K1 decisions (p_tar {p_tar:.6g}) equal to one "
        f"rank's on {min(a for a, _ in agree):.0%} and {min(d for _, d in agree):.0%} of rows "
        f"(held above only where one rank's margins clear the bound)", timed=True)
    say(f"a. {cfg.name} training: " + bf16_train_line(one_t, tr, "enc_bf16", spec["train"]),
        timed=True)
    cfg = runs_s["enc_f32"]["cfg"]
    say(f"b. {cfg.name} float32 twin, uncut: "
        + serving_line(one_s, sv, runs_s, flops, world, "enc_f32", None), timed=True)
    run = runs_t["enc_f32"]
    gap = same_metrics(one_t, tr, "enc_f32")
    r0 = tr[0]["runs"]["enc_f32"]
    assert all(p["runs"]["enc_f32"]["ckpt_back"] for p in tr)
    say(f"b. float32 twin training, {run['steps']} steps at {run['batch'][0]} x "
        f"{run['batch'][1]}: losses and grad_norm within rel {gap:.3g}; "
        + held_line(one_t, tr, "enc_f32", run["steps"])
        + f"; {r0['replicated_equal']} replicated elements (the norms, the position "
        f"embeddings" + (", the embedding and heads, whose vocabulary the ranks do not divide"
                         if cfg.vocab_size % world else "") + ") bit-equal over the ranks; "
        f"the ranks' checkpoint, one device's layout, written in {r0['ckpt_save_s']:.2f} s and "
        f"reloaded bit for bit on every rank; " + train_line(one_t, tr, "enc_f32"), timed=True)
    t_gap, n_gap, c_gap, held, p_tar = held_calibration(one_s, sv, "enc_f32")
    w0, c0 = one_s["runs"]["enc_f32"]["calib"], sv[0]["runs"]["enc_f32"]["calib"]
    calib = runs_s["enc_f32"]["calib"]
    say(f"c. the twin calibrated over the mesh: the eval step's whole-vocab exit logits of "
        f"{calib['val'][0]} x {calib['val'][1]} validation tokens in {c0['eval_ms']:.1f} ms "
        f"(one rank {w0['eval_ms']:.1f}); K2 fit per exit (T, plain T, NLLs) rank 0 "
        f"{[tuple(round(v, 6) for v in f) for f in c0['fits']]}, one rank "
        f"{[tuple(round(v, 6) for v in f) for f in w0['fits']]}: T within rel {t_gap:.3g} "
        f"(2e-4), NLL within rel {n_gap:.3g}; planted T* = 1.5: rank 0 K2 "
        f"{c0['planted'][0]:.6f} (plain {c0['planted'][1]:.6f}), one rank "
        f"{w0['planted'][0]:.6f}; the plan of one rank's temperatures "
        f"{[round(t, 6) for t in one_s['plans']['enc_f32']]} served through "
        f"make_prefill_step(plan=) on {calib['serve'][0]} x {calib['serve'][1]}: confidences "
        f"within rel {c_gap:.3g} (rtol / atol 2e-4), {held} predictions and decisions (p_tar "
        f"{p_tar:.6g}) equal where one rank's margins clear it; ms one rank "
        f"{w0['serve_ms']:.1f}, rank 0 {c0['serve_ms']:.1f}", timed=True)
    say("launches per rank (K1, K3, K4, K2): " + "; ".join(
        f"rank {p['rank']} {tuple(p['launches'].values())}" for p in reps))
    return summed_launches(reps)


def main() -> int:
    import torch

    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.utils._pytree as pytree

    from repro_torch.core import metrics
    from repro_torch.core.calibration import fit_temperature
    from repro_torch.core.partition import select_partition
    from repro_torch.core.policy import OffloadPlan, make_plan
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.kernels import _build, calib_nll, compress, exit_gate, ops, qk_rope, ref
    from repro_torch.models import convnet
    from repro_torch.offload import latency
    from repro_torch.offload.engine import EngineStats, convnet_engine

    kernels = {"exit_gate": exit_gate.KERNEL, "calib_nll": calib_nll.KERNEL,
               "encode": compress.ENCODE, "decode": compress.DECODE,
               "qk_norm_rope": qk_rope.KERNEL}
    cuda = torch.device("cuda")

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = f"[{smi}]"

    def sayer(tag):
        def say(msg, timed=False):
            print(f"[{tag}] {msg}" + (f" {card}" if timed else ""))
        return say

    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}; TF32 off")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] nvcc sm_90a -> {os.path.relpath(_build.build(), ROOT)} "
          f"in {time.perf_counter() - t0:.1f} s {card}")
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line:
            print("[build] " + line.strip())

    # ---------------------------------------------------------------- 3
    rng = np.random.default_rng(0)
    rows_out = {k: {"cases": []} for k in kernels}

    # the launch floor: a 1-element in-place add_ in the same graph harness
    one = torch.zeros(1, device=cuda)
    floor_ms = device_ms(lambda i: one.add_(1))
    print(f"[kernels] launch floor (1-element add_, graph replay): {floor_ms * 1e3:.2f} us "
          f"{card}")

    def record(kernel, case, err, ms, plain_ms, nbytes, flops, path=False, **extra):
        bms, by = bound_ms(nbytes, flops)
        row = dict(case=case, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, **extra)
        rows_out[kernel]["cases"].append(row)
        if path:
            rows_out[kernel].update(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                                    bound_ms=bms, bound_by=by)
        more = "".join(f"  {k[:-3]} {v * 1e3:.2f} us" for k, v in extra.items())
        print(f"[kernels] {kernel} {case}: max_abs_err {err:.3g}  kernel {ms * 1e3:.2f} us  "
              f"plain {plain_ms * 1e3:.2f} us  bound {bms * 1e3:.2f} us ({by}, {bms / ms:.1%} of "
              f"it){more} {card}")

    def maxdiff(a, b):
        return float((a.double() - b.double()).abs().max())

    def division_ties(temp, n):
        """n pairs x1 < x2 of neighbouring float32 values whose quotients by
        temp round to one float32, from (42 + j) * 2^(j % 6) up (where a
        divide by 1.3 maps a binade into a coarser one). An argmax of z/T
        keeps x1's lower column; a divide off by one ulp would not."""
        t = np.float32(temp)
        pairs = []
        for j in range(n):
            start = np.float32((42 + j) * 2.0 ** (j % 6)).view(np.uint32)
            xs = (start + np.arange(4096, dtype=np.uint32)).view(np.float32)
            q = xs / t
            k = int(np.flatnonzero(q[:-1] == q[1:])[0])
            pairs.append((xs[k], xs[k + 1]))
        return pairs

    # K1 -- exit_gate. The serving gate shape; then each layout at its
    # edges (vocab <= 32 lane groups, 33..1024 a warp per row, above a block
    # per row; odd widths leave most rows unaligned, 3 rows underfill a
    # block); then the large-vocab check, timed L2-cold. Rows 0-2 of the
    # large cases hold +-1e4 and all-equal rows; row 3 a tie at columns 7
    # and 4000, which lie in different warps of the block layout; rows 4-19
    # a division tie (x1 at a lower column than x2) as the row's max.
    # Last, the LM serving gates: one exit of a Qwen3-8B step at batch 8, and
    # one exit of a mamba2-130m decode step at batch 2 (raw bf16 logits).
    f32, bf16 = torch.float32, torch.bfloat16
    k1_cases = [((512, 10), f32), ((1, 10), f32), ((2048, 10), f32), ((1024, 10), f32),
                ((3, 1), f32), ((3, 10), bf16), ((64, 32), f32), ((64, 33), bf16), ((64, 1024), f32), ((3, 1025), f32), ((3, 1025), bf16),
                ((64, 4097), f32), ((64, 4097), bf16), ((5, 8193), f32), ((5, 8193), bf16),
                ((256, 151_936), f32), ((256, 151_936), bf16), ((8, 151_936), bf16),
                ((2, 50_280), bf16)]
    for shape, dtype in k1_cases:
        rows, vocab = shape
        temp = 1.37 if shape == (512, 10) else 1.3
        big = vocab == 151_936
        nbytes = rows * vocab * (2 if dtype == bf16 else 4) + rows * 12
        sets, calls = cold_plan(nbytes) if big else (1, calls_for(nbytes))
        ties = division_ties(temp, min(16, rows - 4)) if vocab >= 8193 and rows > 4 else []
        zs = []
        for _ in range(sets):
            zn = (rng.standard_normal(shape) * 6).astype(np.float32)
            if big:
                zn[0, :4] = [1e4, -1e4, 0.0, 500.0]
                zn[1, :] = -1e4
                zn[2, :] = 1e4
            if vocab >= 8193 and rows > 3:
                zn[3, [7, 4000]] = 50.0
            for r, (x1, x2) in enumerate(ties, start=4):
                zn[r, [100 + r, 3000 + 37 * r]] = [x1, x2]
            zs.append(torch.as_tensor(zn, device=cuda).to(dtype))
        z = zs[0]
        t_dev = torch.tensor(temp, device=cuda)
        conf, ent, idx = exit_gate.exit_gate_kernel(z, temp)
        rconf, rent, ridx = ref.exit_gate_ref(z, t_dev)
        torch.testing.assert_close(conf, rconf, **K1_CONF)
        torch.testing.assert_close(ent, rent, **K1_ENT)
        assert torch.equal(idx, ridx), f"K1 argmax differs from the plain version at {shape}"
        if vocab >= 8193 and rows > 3:
            assert int(idx[3]) == 7, "K1 lost the lower index of a cross-warp tie"
        if ties and dtype == f32:
            assert idx[4:4 + len(ties)].tolist() == [100 + r for r in range(4, 4 + len(ties))], \
                "K1 broke a division tie: its z/T differs from the IEEE quotient"
        ms = device_ms(lambda i: exit_gate.exit_gate_kernel(zs[i % sets], temp), calls, keep=big)
        pms = device_ms(lambda i: ref.exit_gate_ref(zs[i % sets], t_dev), calls, keep=big)
        extra = {} if big else {"launch_floor_ms": floor_ms}
        record("exit_gate", f"{shape} {str(dtype)[6:]}", max(maxdiff(conf, rconf), maxdiff(ent, rent)),
               ms, pms, nbytes, 6.0 * rows * vocab, path=(shape == (512, 10)), **extra)

    # K2 -- calib_nll. The calibration shape beside the launch floor; then
    # each layout at its edges (vocab <= 32 lane groups, 33..1024 a warp per
    # row, above a block per row; odd widths leave rows unaligned, so the
    # scalar head and tail run) at T 0.5 and 2.7, some in bf16; T < 0, which
    # takes the kernel's IEEE-divide branch; then the large-vocab check in
    # f32 and bf16 (622 and 311 MB, far above the L2, so cold in effect).
    # z_y must equal the input bit for bit; nll per row and the Newton
    # statistics within K2_NLL, K2_D1, K2_D2. Last, the LM's temperature
    # fit: one exit's (128, 151936) bf16 validation logits at T 20, and a
    # mamba2-130m exit's (16 x 128, 50280) bf16 held-out logits.
    k2_edges = [(3, 1), (5, 32), (5, 33), (3, 1024), (3, 1025), (4, 4097), (5, 8193)]
    k2_cases = ([((2000, 10), 2.7, f32)]
                + [(shape, temp, f32) for shape in k2_edges for temp in (0.5, 2.7)]
                + [((5, 10), 2.7, bf16), ((5, 33), 2.7, bf16), ((3, 1025), 0.5, bf16),
                   ((5, 8193), 2.7, bf16), ((16, 10), -1.5, f32), ((3, 1025), -0.8, f32),
                   ((1024, 151_936), 1.3, f32), ((1024, 151_936), 1.3, bf16),
                   ((128, 151_936), 20.0, bf16), ((2048, 50_280), 1.3, bf16)])
    for shape, temp, dtype in k2_cases:
        rows, vocab = shape
        big = vocab == 151_936
        z = torch.as_tensor((rng.standard_normal(shape) * 4).astype(np.float32),
                            device=cuda).to(dtype)
        y = torch.as_tensor(rng.integers(0, vocab, rows).astype(np.int32), device=cuda)
        t_dev = torch.tensor(temp, device=cuda)
        got = calib_nll.calib_nll_kernel(z, y, t_dev)
        want = ref.calib_nll_ref(z, y, t_dev)
        case = f"{shape} {str(dtype)[6:]} T={temp}"
        assert torch.equal(got[2], want[2]), f"K2 label logit differs from the plain one: {case}"
        torch.testing.assert_close(got[3], want[3], **K2_NLL, msg=lambda m: f"K2 nll ({case}): {m}")
        s_got, s_want = ops.newton_stats(*got, t_dev), ops.newton_stats(*want, t_dev)
        for a, b, tol in zip(s_got, s_want, (K2_NLL, K2_D1, K2_D2)):
            torch.testing.assert_close(a, b, **tol, msg=lambda m: f"K2 ({case}): {m}")
        nbytes = rows * vocab * (2 if dtype == bf16 else 4) + rows * 4 + 4 + rows * 16
        calls = calls_for(nbytes)
        ms = device_ms(lambda i: calib_nll.calib_nll_kernel(z, y, t_dev), calls)
        pms = device_ms(lambda i: ref.calib_nll_ref(z, y, t_dev), calls)
        extra = {} if big else {"launch_floor_ms": floor_ms}
        err = max([maxdiff(got[3], want[3])] + [maxdiff(a, b) for a, b in zip(s_got, s_want)])
        record("calib_nll", case, err, ms, pms, nbytes, 10.0 * rows * vocab,
               path=(shape == (2000, 10) and dtype == f32), **extra)
    # the kernel Newton fit against the plain fitter on a planted T* = 2.5
    zn = (rng.standard_normal((2000, 10)) * 3).astype(np.float32)
    p = np.exp(zn / 2.5)
    p /= p.sum(1, keepdims=True)
    yn = (p.cumsum(1) > rng.random((2000, 1))).argmax(1).astype(np.int32)
    zc, yc = torch.as_tensor(zn, device=cuda), torch.as_tensor(yn, device=cuda)
    t_k, _ = ops.fit_temperature_kernel(zc, yc)
    t_r, _ = fit_temperature(zc, yc)
    print(f"[kernels] calib_nll Newton fit: kernel T {float(t_k):.5f}  plain fitter T "
          f"{float(t_r):.5f}  (planted 2.5)")
    assert abs(float(t_k) - float(t_r)) < 0.05 and 2.2 < float(t_k) < 2.9
    # the same fit on bf16 logits, which K2 reads as they are
    zb = zc.to(bf16)
    t_kb, _ = ops.fit_temperature_kernel(zb, yc)
    t_rb, _ = fit_temperature(zb.float(), yc)
    print(f"[kernels] calib_nll Newton fit on bf16 logits: kernel T {float(t_kb):.5f}  plain "
          f"fitter T {float(t_rb):.5f}")
    assert abs(float(t_kb) - float(t_rb)) < 0.05 and 2.2 < float(t_kb) < 2.9

    # K3 / K4 -- codec, bit-exact on words, scales and decoded floats
    def bits_equal(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    zero_half = np.zeros((8, 512), np.float32)
    zero_half[:, 256:] = rng.standard_normal((8, 256)) * 3
    nonfinite = (rng.standard_normal((8, 512)) * 3).astype(np.float32)
    nonfinite[0, 5], nonfinite[3, 200], nonfinite[7, 300] = np.inf, -np.inf, np.nan
    # the path's payloads at full and at the served refused size m = 252,
    # a ragged last group (3, 700), rows that are not 16-byte aligned
    # (5, 301: cols % 4 != 0), an all-zero group and inf/nan inputs, and
    # rescore_plan's codec axis: (n, 10) logits, one partial group per row
    # and cols % 4 != 0; the runtime's shapes: one request's payload per
    # branch at levels 1 and 2 (timed L2-warm beside the launch floor: the
    # edge forward has just written it) and the congested scenario's
    # (2048, 10) final logits; the fleet's: a context's (1024, 10) final
    # logits (cloud tables) and the controller core's four contexts'
    # (4096, 10); the LM's: lm_engine's refused rows of a Qwen3-8B (512,
    # 4096) hidden, (4, 512 * 4096), with 16 384 groups a row, and of a
    # granite-moe (512, 1536) hidden, (4, 512 * 1536). Every payload of 1 MB
    # or more is timed L2-warm and L2-cold. Last, K3's division ties in each
    # of its five layouts (asserted): quotients z / scale exactly on k + 0.5,
    # their float32 neighbours, absmax-only and +-absmax groups and a
    # subnormal scale (`ref.codec_tie_payload`), where a divide off by one
    # ulp changes codes; the wide layouts take payloads of more than
    # `compress.QUAD_PAIRS` (row, group) pairs.
    codec_cases = [((512, 16, 16, 64), 1, None), ((512, 16, 16, 64), 2, None),
                   ((1, 16, 16, 64), 1, None), ((1, 16, 16, 64), 2, None),
                   ((1, 8, 8, 96), 1, None), ((1, 8, 8, 96), 2, None), ((2048, 10), 2, None),
                   ((252, 16, 16, 64), 1, None), ((252, 16, 16, 64), 2, None),
                   ((256, 8, 8, 96), 1, None), ((256, 8, 8, 96), 2, None),
                   ((252, 8, 8, 96), 1, None), ((252, 8, 8, 96), 2, None),
                   ((3, 700), 1, None), ((3, 700), 2, None),
                   ((5, 301), 1, None), ((5, 301), 2, None),
                   ((8, 512), 2, zero_half), ((8, 512), 1, nonfinite), ((8, 512), 2, nonfinite),
                   ((1024, 10), 2, None), ((4096, 10), 1, None), ((4096, 10), 2, None),
                   ((3000, 10), 1, None), ((3000, 10), 2, None),
                   ((7000, 10), 1, None), ((7000, 10), 2, None),
                   ((4, 2_097_152), 1, None), ((4, 2_097_152), 2, None),
                   ((4, 786_432), 1, None), ((4, 786_432), 2, None)]
    wide_rows = compress.QUAD_PAIRS // 128 + 8  # at 16 384 features: more than QUAD_PAIRS pairs
    tie_shapes = ((64, 1024), (33, 301), (257, 10), (wide_rows, 16_384), (wide_rows, 16_383))
    codec_cases += [((rows, cols), level, ref.codec_tie_payload(rows, cols, ref.CODEC_BITS[level],
                                                                seed=rows + level))
                    for rows, cols in tie_shapes for level in (1, 2)]
    tie_kinds = set()
    for shape, level, fixed in codec_cases:
        xn = fixed if fixed is not None else (rng.standard_normal(shape) * 3).astype(np.float32)
        x = torch.as_tensor(xn, device=cuda)
        bits = ref.CODEC_BITS[level]
        rows, cols = ref._codec_layout(shape)
        x2 = x.reshape(rows, cols)
        if fixed is not None and shape in tie_shapes:
            tie_kinds.add(compress.encode_layout(rows, cols, x2.data_ptr() % 16 == 0).kind)
        words, scales = compress.encode_kernel(x2, bits)
        rwords, rscales = ref.encode_codec_ref(x, level)
        assert bits_equal(words, rwords), f"K3 words differ at {shape} level {level}"
        assert bits_equal(scales, rscales), f"K3 scales differ at {shape} level {level}"
        out = compress.decode_kernel(words, scales, cols, bits).reshape(shape)
        rout = ref.decode_codec_ref(words, scales, shape, level)
        assert bits_equal(out, rout), f"K4 floats differ at {shape} level {level}"
        assert torch.isfinite(out).all()
        if fixed is None and (shape[1:] == (10,) or shape[0] == 1):  # logits, one request: L2-warm
            nbytes = rows * cols * 4 + words.numel() * 4 + scales.numel() * 4
            case = f"{shape} level {level}"
            record("encode", case, 0.0, device_ms(lambda i: compress.encode_kernel(x2, bits)),
                   device_ms(lambda i: ref.encode_codec_ref(x, level)), nbytes, 5.0 * rows * cols,
                   launch_floor_ms=floor_ms)
            record("decode", case, 0.0,
                   device_ms(lambda i: compress.decode_kernel(words, scales, cols, bits)),
                   device_ms(lambda i: ref.decode_codec_ref(words, scales, shape, level)),
                   nbytes, 3.0 * rows * cols, launch_floor_ms=floor_ms)
        if fixed is None and rows * cols * 4 >= 1e6:  # the batches' and the LMs' payloads
            # L2-warm: the same buffers every call;
            # L2-cold: inputs rotate over sets and every output is fresh
            wbytes = words.numel() * 4 + scales.numel() * 4
            nbytes = rows * cols * 4 + wbytes
            sets, calls = cold_plan(nbytes)
            xs = [x] + [torch.randn_like(x) * 3 for _ in range(sets - 1)]
            encs = [(words, scales)] + [compress.encode_kernel(xi.reshape(rows, cols), bits)
                                        for xi in xs[1:]]
            case = f"{shape} level {level}"
            enc_warm = device_ms(lambda i: compress.encode_kernel(x2, bits), calls_for(nbytes))
            dec_warm = device_ms(lambda i: compress.decode_kernel(words, scales, cols, bits),
                                 calls_for(nbytes))
            record("encode", case, 0.0,
                   device_ms(lambda i: compress.encode_kernel(xs[i % sets].reshape(rows, cols),
                                                              bits), calls, keep=True),
                   device_ms(lambda i: ref.encode_codec_ref(xs[i % sets], level), calls,
                             keep=True),
                   nbytes, 5.0 * rows * cols, path=(level == 2 and rows == 512),
                   warm_ms=enc_warm)
            record("decode", case, 0.0,
                   device_ms(lambda i: compress.decode_kernel(*encs[i % sets], cols, bits),
                             calls, keep=True),
                   device_ms(lambda i: ref.decode_codec_ref(*encs[i % sets], shape, level),
                             calls, keep=True),
                   nbytes, 3.0 * rows * cols, path=(level == 2 and rows == 512),
                   warm_ms=dec_warm)
    assert tie_kinds == set(compress.ENCODE_LAYOUTS), f"K3 ties missed layouts: {tie_kinds}"
    # a base pointer off 16 bytes takes K3's quad_scalar and wide_scalar layouts
    for (rows, cols), kind in (((4, 16_384), "quad_scalar"), ((wide_rows, 16_384), "wide_scalar")):
        xo = (torch.randn(rows * cols + 1, device=cuda) * 3)[1:].view(rows, cols)
        for level in (1, 2):
            bits = ref.CODEC_BITS[level]
            assert compress.encode_layout(rows, cols, xo.data_ptr() % 16 == 0).kind == kind
            words, scales = compress.encode_kernel(xo, bits)
            rwords, rscales = ref.encode_codec_ref(xo, level)
            assert bits_equal(words, rwords) and bits_equal(scales, rscales), \
                f"K3 differs on an unaligned base pointer ({kind}, level {level})"
    print("[kernels] K3 layouts: " + "; ".join(
        f"{shape} {lay.kind} {lay.blocks} x {lay.threads}"
        for shape, lay in ((shape, compress.encode_layout(*shape, True))
                           for shape in ((1, 16_384), (1, 6144), (3000, 10), (5, 301),
                                         (512, 16_384), (4, 786_432)))))
    print(f"[kernels] codec bit-exact on {len(codec_cases) + 4} cases (words, scales, floats)")

    # K5 -- qk-norm and RoPE, within one bf16 ulp of the plain chain
    qk_rope_checks(cuda, record, say=lambda m, timed=False: print(f"[kernels] {m}"))

    # ---------------------------------------------------------------- 4
    phase_launches = {}

    def run_phase(phase, fn, in_ranks=False):
        """Drive one main-path phase with the launch counts set to 0 just
        before it and read just after; every kernel of its path must run.
        `in_ranks`: the phase runs its path in other processes, whose
        counts (each set to 0 before its path and read after) it returns;
        this process must launch nothing."""
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn(sayer(phase))
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        if in_ranks:
            assert not any(counts.values()), f"the {phase} phase launched here: {counts}"
            counts = {n: out.get(n, 0) for n in kernels}
        phase_launches[phase] = counts
        print(f"[{phase}] phase in {time.perf_counter() - t0:.2f} s; launches {counts} {card}")
        missing = [n for n in PHASE_KERNELS[phase] if counts[n] == 0]
        assert not missing, f"kernels never launched on the {phase} path: {missing}"
        return out

    t0 = time.perf_counter()
    data = cifar_like(seed=0)
    print(f"[train] cifar_like(seed=0): {len(data.train_y)} / {len(data.val_y)} / "
          f"{len(data.test_y)} images made (numpy) in {time.perf_counter() - t0:.2f} s {card}")
    params, z, tstats = run_phase("train", lambda say: train_phase(cuda, data, 6, 256, say=say))
    assert tstats["finite"], "a training loss is not finite"
    assert tstats["epoch_loss"][-1] < tstats["first_loss"], tstats
    # two runs on the card and the reference's CPU run of the same recipe
    # all reached 0.85-0.87 on every exit; 0.8 leaves room for cuDNN's
    # run-to-run freedom and still fails a training that went wrong
    low = {k: v for k, v in tstats["accuracy"].items() if k.startswith("test") and v < 0.8}
    assert not low, f"exits below 0.8 test accuracy: {low}"

    # ---------------------------------------------------------------- 5
    (v1, v2, _), val_y = z["val"], z["val_y"]
    test_x = torch.as_tensor(data.test_x[:4096], device=cuda)
    test_y = data.test_y[:4096]
    profile = latency.paper_2020()

    def serving(say):
        plan = make_plan([v1, v2], val_y, p_tar=0.8)
        t_fit, _ = ops.fit_temperature_kernel(v1, val_y)  # calibrating on the card: K2
        say(f"temperatures {plan.temperatures}; K2 Newton fit of branch 1 {float(t_fit):.5f}")
        assert abs(float(t_fit) - plan.temperatures[0]) < 0.05
        plan, cands = select_partition(
            plan, [v1, v2],
            edge_times_s=[latency.edge_time(profile, b) for b in (1, 2)],
            cloud_times_s=[latency.cloud_time(profile, b) for b in (1, 2)],
            payload_bytes=[latency.payload_bytes_for(b) for b in (1, 2)],
            exit_layer_indices=[0, 1], uplink_bps=profile.uplink_bps,
        )
        text = plan.to_json()
        plan = OffloadPlan.from_json(text)
        assert plan.to_json() == text
        say(f"p_tar {plan.p_tar:.6f}; partition exit {plan.exit_index} "
            f"(offload probs {[round(c.offload_prob, 4) for c in cands]}); JSON round trip ok")
        offload_rates, stats = {}, {}
        for branch, level in [(1, 0), (1, 1), (1, 2), (2, 2)]:
            engine = convnet_engine(params, plan.with_compression(level), branch=branch,
                                    use_kernel=True)
            engine.infer({"images": test_x[:512]})  # warm-up: cuDNN picks its algorithms
            engine.stats = EngineStats()
            before = {n: k.launches for n, k in kernels.items()}
            t0 = time.perf_counter()
            res = [engine.infer({"images": test_x[i:i + 512]}) for i in range(0, len(test_x), 512)]
            wall = time.perf_counter() - t0
            pred = np.concatenate([r["prediction"] for r in res])
            conf = np.concatenate([r["confidence"] for r in res])
            on_dev = np.concatenate([r["on_device"] for r in res])
            assert (pred.shape == conf.shape == on_dev.shape == test_y.shape
                    and np.isfinite(conf).all())
            correct = pred == test_y
            outage = np.mean([
                bool(m.any()) and (c[m].mean() < plan.p_tar)
                for m, c in zip(on_dev.reshape(-1, metrics.PAPER_OUTAGE_BATCH),
                                correct.reshape(-1, metrics.PAPER_OUTAGE_BATCH))
            ])
            st = engine.stats
            want = st.offloaded * compress.scaled_payload_nbytes(convnet.payload_bytes(branch),
                                                                 level)
            delta = {n: k.launches - before[n] for n, k in kernels.items()}
            say(f"branch {branch} level {level}: offload_rate {st.offload_rate:.4f} "
                f"accuracy {correct.mean():.4f} ece {metrics.ece(conf, correct):.4f} "
                f"on_device_prob {on_dev.mean():.4f} on_device_accuracy "
                f"{correct[on_dev].mean() if on_dev.any() else float('nan'):.4f} "
                f"outage {outage:.3f} payload_bytes {st.payload_bytes} infer "
                f"{1e3 * wall / len(res):.3f} ms/batch (edge {1e3 * st.edge_time_s / len(res):.3f},"
                f" cloud {1e3 * st.cloud_time_s / len(res):.3f}) launches {delta}", timed=True)
            assert 0.0 < st.offload_rate < 1.0, (branch, level, st.offload_rate)
            offload_rates[branch, level] = st.offload_rate
            stats[branch, level] = st
            assert st.payload_bytes == want, (st.payload_bytes, want)
            assert delta["exit_gate"] >= len(res)
            if level == 0:
                assert delta["encode"] == delta["decode"] == 0
            else:
                assert delta["encode"] >= 1 and delta["decode"] >= 1
        # the gate runs before the codec, so the level cannot move who offloads
        assert offload_rates[1, 0] == offload_rates[1, 1] == offload_rates[1, 2], offload_rates
        return plan, stats

    serving_plan, serving_stats = run_phase("serving", serving)

    # edge_forward on the card against the CPU port, on the trained weights
    # the serving phase served and on the seeded initial ones. cuDNN and the
    # CPU sum in different orders; the tolerance follows from that: per
    # output, atol = 8 * 2**-24 * max|output| * the sum over the layers that
    # feed it of sqrt(reduction length) (the random-walk bound of a float32
    # dot product, both sides erring), rtol 1e-4.
    def reduction(p):
        w = p["w"]
        return w[0].numel() if w.dim() == 4 else w.shape[0]  # cin*k*k or din

    def edge_check(weights, label):
        cpu_w = pytree.tree_map(lambda x: x.cpu(), weights)
        readings = []
        with torch.no_grad():
            for branch in (1, 2):
                lg, pl = convnet.edge_forward(weights, test_x[:64], branch=branch)
                lc, pc = convnet.edge_forward(cpu_w, test_x[:64].cpu(), branch=branch)
                assert pl.is_contiguous() and tuple(pl.shape[1:]) == ((16, 16, 64) if branch == 1
                                                                     else (8, 8, 96))
                trunk = [weights[f"conv{i}"] for i in range(1, branch + 1)]
                head = weights[f"branch{branch}"]
                for what, got, want, layers in (("payload", pl, pc, trunk),
                                                ("logits", lg, lc, trunk + [head["conv"],
                                                                            head["fc"]])):
                    scale = want.abs().max().item()
                    atol = 8 * 2.0 ** -24 * scale * sum(reduction(q) ** 0.5 for q in layers)
                    err = (got.cpu() - want).abs().max().item()
                    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=atol)
                    readings.append(f"branch {branch} {what} max|out| {scale:.6g} max err "
                                    f"{err:.6g} atol {atol:.6g}")
        print(f"[serving] edge_forward on the card matches the CPU port on the {label} weights "
              f"(rtol 1e-4): " + "; ".join(readings))

    edge_check(params, "trained")
    edge_check(convnet.init_params(torch.Generator(device=cuda).manual_seed(0), device=cuda),
               "seeded initial")

    # ---------------------------------------------------------------- 6
    paper = run_phase("paper", lambda say: paper_phase(cuda, z, say=say))
    for a, b in zip(paper["t_k2"], paper["t_plain"]):
        assert abs(a - b) <= 1e-3 * b, ("K2 and the plain fit disagree", paper["t_k2"],
                                        paper["t_plain"])
    bad = [v for v in paper["values"] if not 0.0 <= v <= 1.0]  # also catches nan
    assert not bad, f"paper values outside [0, 1]: {bad}"

    # ---------------------------------------------------------------- 7
    run_phase("bank", lambda say: bank_phase(cuda, params, data, z, say=say))

    # ---------------------------------------------------------------- 8
    from repro_torch.serving.scenarios import fit_drift_plans, synthetic_distorted_cascade

    t0 = time.perf_counter()
    rt_plan = make_plan([v1, v2], val_y, p_tar=0.8)
    val_d, test_d = synthetic_distorted_cascade()
    drift_plans = fit_drift_plans(val_d, device=cuda)
    print(f"[runtime] set-up: the trained plan (T {rt_plan.temperatures}), the drift "
          f"scenario's data (numpy) and plans fit on the card in "
          f"{time.perf_counter() - t0:.2f} s {card}")
    run_phase("runtime", lambda say: runtime_phase(cuda, params, data, rt_plan,
                                                   (val_d, test_d, drift_plans), say=say))

    # ---------------------------------------------------------------- 9
    t0 = time.perf_counter()
    val_f, test_f = synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    fleet_plans = fit_drift_plans(val_f, device=cuda)
    host_plans = fit_drift_plans(val_f, device="cpu")  # only to report the gap in T

    def temps(plans):
        _, glob, bank = plans
        return np.array(glob.temperatures + [t for c in bank.contexts
                                             for t in bank.plan_for(c).temperatures])

    dt = float(np.max(np.abs(temps(fleet_plans) / temps(host_plans) - 1.0)))
    print(f"[fleet] set-up: the fleet bench's data (numpy) and plans fit on the card in "
          f"{time.perf_counter() - t0:.2f} s; the same fits on the CPU differ in T by "
          f"rel {dt:.3g} at most {card}")
    fleet_sums = run_phase("fleet", lambda say: fleet_phase(cuda, val_f, test_f, fleet_plans,
                                                            say=say))

    # ---------------------------------------------------------------- 10
    compiled_tels = run_phase("compiled", lambda say: compiled_phase(
        cuda, val_f, test_f, fleet_plans, fleet_sums, say=say))

    # ---------------------------------------------------------------- 11
    from repro_torch.configs import get_config

    lm_cfg = get_config("qwen3-8b")
    run_phase("lm", lambda say: lm_phase(cuda, lm_cfg, say=say))

    # ---------------------------------------------------------------- 12
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    run_phase("train_lm", lambda say: train_lm_phase(cuda, train_lm_spec(), ckpt_dir, say=say))

    # ---------------------------------------------------------------- 13
    run_phase("dryrun", lambda say: dryrun_phase(cuda, params, serving_plan, serving_stats,
                                                 test_x, say=say))

    # ---------------------------------------------------------------- 14
    spec = ranks_spec()
    run_phase("ranks", lambda say: ranks_phase(
        cuda, spec, ranks_data(spec, data.train_x, data.train_y),
        (val_f, test_f, fleet_plans, compiled_tels), os.path.join(ckpt_dir, "ranks"),
        say=say), in_ranks=True)

    # ---------------------------------------------------------------- 15
    run_phase("tp", lambda say: tp_phase(cuda, tp_spec(), os.path.join(ckpt_dir, "tp"),
                                         say=say), in_ranks=True)

    # ---------------------------------------------------------------- 16
    run_phase("tp_train", lambda say: tp_train_phase(
        cuda, tp_train_spec(), os.path.join(ckpt_dir, "tp_train"), say=say), in_ranks=True)

    # ---------------------------------------------------------------- 17
    run_phase("tp_ssm", lambda say: tp_ssm_phase(
        cuda, tp_ssm_spec(), os.path.join(ckpt_dir, "tp_ssm"), say=say), in_ranks=True)

    # ---------------------------------------------------------------- 18
    run_phase("tp_enc_dec", lambda say: tp_enc_dec_phase(
        cuda, tp_enc_dec_spec(), os.path.join(ckpt_dir, "tp_enc_dec"), say=say), in_ranks=True)

    # ---------------------------------------------------------------- 19
    print(f"[result] the script in {time.perf_counter() - script_t0:.2f} s {card}")
    launches = {n: sum(c[n] for c in phase_launches.values()) for n in kernels}
    table = []
    for n in kernels:
        src, replaces = KERNEL_ROWS[n]
        r = rows_out[n]
        table.append({"name": n, "route": "cuda", "source": src, "replaces": replaces,
                      "launches": launches[n], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": None,
                      "launches_by_phase": {p: c[n] for p, c in phase_launches.items()},
                      "cases": r["cases"]})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks":
        sys.exit(rank_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--tp":
        sys.exit(tp_rank_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-train":
        sys.exit(tp_train_rank_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] in ("--tp-ssm", "--tp-enc-dec"):
        sys.exit(tp_model_rank_main(sys.argv[2]))
    sys.exit(main())
