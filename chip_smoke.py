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
            (256,151936) and K3/K4 at (512,16384), which are L2-cold:
            inputs rotate over sets and every call writes fresh outputs,
            so over 100 MB pass between two uses of a buffer. K3/K4 print
            their L2-warm time beside it. K2 at (1024,151936) reuses its
            buffers, but its 311 MB (bf16) and 622 MB (f32) inputs are far
            above the 50 MB L2.
            The codec also runs bit-exact at the (n, 10) logit shapes
            of rescore_plan's codec axis, (3000, 10) and (7000, 10), and
            of the fleet, (1024, 10) and (4096, 10); K1 at the runtime's
            and the fleet's (1, 10), (1024, 10) and (2048, 10).
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
10. result  one JSON line with every kernel's numbers, the nvidia-smi
            line, and last {"ok": true, "device": {...}}.

Phases 4-9 are the main path: each sets the launch counts to 0 just
before it and reads them just after, and fails if a kernel of its path
did not run (train: K1; serving: K1-K4; paper: K1, K2; bank: K1, K3,
K4; runtime: K1, K3, K4; fleet: K1, K3, K4). Every line that prints a
time names the card and its power limit.

Any failure raises, so the process exits non-zero and prints no result;
without a GPU it exits 2 before doing anything. Imports neither jax nor
the JAX package.
"""
from __future__ import annotations

import json
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
# the kernels each main-path phase must launch
PHASE_KERNELS = {"train": ("exit_gate",),
                 "serving": ("exit_gate", "calib_nll", "encode", "decode"),
                 "paper": ("exit_gate", "calib_nll"),
                 "bank": ("exit_gate", "encode", "decode"),
                 "runtime": ("exit_gate", "encode", "decode"),
                 "fleet": ("exit_gate", "encode", "decode")}
# K1's boundary: the kernel's conf = 1/S and the plain max(exp(logp)) are
# about 1e-7 apart, so decisions are compared only away from p_tar +- this
BOUNDARY = 1e-6

KERNEL_ROWS = {
    "exit_gate": ("src/repro_torch/csrc/exit_gate.cu", "src/repro/kernels/exit_gate.py:88"),
    "calib_nll": ("src/repro_torch/csrc/calib_nll.cu", "src/repro/kernels/calib_nll.py:81"),
    "encode": ("src/repro_torch/csrc/codec.cu", "src/repro/kernels/compress.py:122"),
    "decode": ("src/repro_torch/csrc/codec.cu", "src/repro/kernels/compress.py:158"),
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


def same_fleet(tel, host, what):
    """Two fleet runs agree: every cell's per-request columns (latencies to
    rel 1e-9, the rest equal), the per-cell and fleet summaries (latencies
    to rel 1e-9, every decision-derived number equal) and the controller's
    switches."""
    from repro_torch.fleet.telemetry import _CellColumns

    assert tel.n_cells == host.n_cells, what
    for c in range(tel.n_cells):
        for f in _CellColumns.FIELDS:
            a, b = tel._cells[c].column(f), host._cells[c].column(f)
            if f == "latency_s":
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=f"{what}: cell {c}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{what}: cell {c} {f}")
    pairs = [("fleet", tel.fleet_summary(), host.fleet_summary())] + [
        (f"cell {c}", a, b)
        for c, (a, b) in enumerate(zip(tel.per_cell_summary(), host.per_cell_summary()))]
    for where, a, b in pairs:
        assert a.keys() == b.keys(), what
        same_fleet_summary(a, b, a, f"{what} {where}")
    assert tel.controller_events == host.controller_events, what
    assert tel.orchestration_events == host.orchestration_events, what


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
    bank), fit on `dev` from `val`."""
    import torch

    from repro_torch.core.gatepath import GateTable, TorchGateBackend
    from repro_torch.fleet import FleetController, FleetControllerConfig
    from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
    from repro_torch.kernels import compress, exit_gate
    from repro_torch.offload import latency
    from repro_torch.orchestration import run_scenarios
    from repro_torch.orchestration.scenarios import _drift_data

    cpu = torch.device("cpu")
    card = dev.type == "cuda"
    counters = {"exit_gate": exit_gate.KERNEL, "encode": compress.ENCODE,
                "decode": compress.DECODE}
    steps = []

    def launches():
        return {n: k.launches for n, k in counters.items()}

    def expect(step, before, **want):
        got = {n: v - before[n] for n, v in launches().items()}
        want = {n: want.get(n, 0) if card else 0 for n in counters}
        assert got == want, f"{step}: launches {got}, worked out {want}"
        steps.append(f"{step} {tuple(got.values())}")

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
            s = tel.fleet_summary()
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
    say("launches per run (K1, K3, K4): " + "; ".join(steps))


def main() -> int:
    import torch

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
    from repro_torch.kernels import _build, calib_nll, compress, exit_gate, ops, ref
    from repro_torch.models import convnet
    from repro_torch.offload import latency
    from repro_torch.offload.engine import EngineStats, convnet_engine

    kernels = {"exit_gate": exit_gate.KERNEL, "calib_nll": calib_nll.KERNEL,
               "encode": compress.ENCODE, "decode": compress.DECODE}
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
    def device_ms(fn, calls=20, reps=5, keep=False):
        """Median device ms of one call: `calls` calls, fn(0) .. fn(calls-1),
        captured in a CUDA graph and replayed `reps` times between CUDA
        events. With keep=True every call's outputs stay allocated, so no
        two calls share an output buffer."""
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
              f"plain {plain_ms * 1e3:.2f} us  bound {bms * 1e3:.2f} us ({by}){more} {card}")

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
    f32, bf16 = torch.float32, torch.bfloat16
    k1_cases = [((512, 10), f32), ((1, 10), f32), ((2048, 10), f32), ((1024, 10), f32),
                ((3, 1), f32), ((3, 10), bf16), ((64, 32), f32), ((64, 33), bf16), ((64, 1024), f32), ((3, 1025), f32), ((3, 1025), bf16),
                ((64, 4097), f32), ((64, 4097), bf16), ((5, 8193), f32), ((5, 8193), bf16),
                ((256, 151_936), f32), ((256, 151_936), bf16)]
    for shape, dtype in k1_cases:
        rows, vocab = shape
        temp = 1.37 if shape == (512, 10) else 1.3
        big = vocab == 151_936
        nbytes = rows * vocab * (2 if dtype == bf16 else 4) + rows * 12
        sets, calls = cold_plan(nbytes) if big else (1, calls_for(nbytes))
        ties = division_ties(temp, min(16, rows - 4)) if vocab >= 8193 else []
        zs = []
        for _ in range(sets):
            zn = (rng.standard_normal(shape) * 6).astype(np.float32)
            if big:
                zn[0, :4] = [1e4, -1e4, 0.0, 500.0]
                zn[1, :] = -1e4
                zn[2, :] = 1e4
            if vocab >= 8193:
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
        if vocab >= 8193:
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
    # statistics within K2_NLL, K2_D1, K2_D2.
    k2_edges = [(3, 1), (5, 32), (5, 33), (3, 1024), (3, 1025), (4, 4097), (5, 8193)]
    k2_cases = ([((2000, 10), 2.7, f32)]
                + [(shape, temp, f32) for shape in k2_edges for temp in (0.5, 2.7)]
                + [((5, 10), 2.7, bf16), ((5, 33), 2.7, bf16), ((3, 1025), 0.5, bf16),
                   ((5, 8193), 2.7, bf16), ((16, 10), -1.5, f32), ((3, 1025), -0.8, f32),
                   ((1024, 151_936), 1.3, f32), ((1024, 151_936), 1.3, bf16)])
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
    # branch and the congested scenario's (2048, 10) final logits; the
    # fleet's: a context's (1024, 10) final logits (cloud tables) and the
    # controller core's four contexts' (4096, 10)
    codec_cases = [((512, 16, 16, 64), 1, None), ((512, 16, 16, 64), 2, None),
                   ((1, 16, 16, 64), 2, None), ((1, 8, 8, 96), 2, None), ((2048, 10), 2, None),
                   ((252, 16, 16, 64), 1, None), ((252, 16, 16, 64), 2, None),
                   ((256, 8, 8, 96), 1, None), ((256, 8, 8, 96), 2, None),
                   ((252, 8, 8, 96), 1, None), ((252, 8, 8, 96), 2, None),
                   ((3, 700), 1, None), ((3, 700), 2, None),
                   ((5, 301), 1, None), ((5, 301), 2, None),
                   ((8, 512), 2, zero_half), ((8, 512), 1, nonfinite), ((8, 512), 2, nonfinite),
                   ((1024, 10), 2, None), ((4096, 10), 1, None), ((4096, 10), 2, None),
                   ((3000, 10), 1, None), ((3000, 10), 2, None),
                   ((7000, 10), 1, None), ((7000, 10), 2, None)]
    for shape, level, fixed in codec_cases:
        xn = fixed if fixed is not None else (rng.standard_normal(shape) * 3).astype(np.float32)
        x = torch.as_tensor(xn, device=cuda)
        bits = ref.CODEC_BITS[level]
        rows, cols = ref._codec_layout(shape)
        x2 = x.reshape(rows, cols)
        words, scales = compress.encode_kernel(x2, bits)
        rwords, rscales = ref.encode_codec_ref(x, level)
        assert bits_equal(words, rwords), f"K3 words differ at {shape} level {level}"
        assert bits_equal(scales, rscales), f"K3 scales differ at {shape} level {level}"
        out = compress.decode_kernel(words, scales, cols, bits).reshape(shape)
        rout = ref.decode_codec_ref(words, scales, shape, level)
        assert bits_equal(out, rout), f"K4 floats differ at {shape} level {level}"
        assert torch.isfinite(out).all()
        if shape[1:] == (10,):  # the logit shapes, L2-warm
            nbytes = rows * cols * 4 + words.numel() * 4 + scales.numel() * 4
            case = f"{shape} level {level}"
            record("encode", case, 0.0, device_ms(lambda i: compress.encode_kernel(x2, bits)),
                   device_ms(lambda i: ref.encode_codec_ref(x, level)), nbytes, 5.0 * rows * cols,
                   launch_floor_ms=floor_ms)
            record("decode", case, 0.0,
                   device_ms(lambda i: compress.decode_kernel(words, scales, cols, bits)),
                   device_ms(lambda i: ref.decode_codec_ref(words, scales, shape, level)),
                   nbytes, 3.0 * rows * cols, launch_floor_ms=floor_ms)
        if fixed is None and shape[0] == 512:
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
                   nbytes, 5.0 * rows * cols, path=(level == 2), warm_ms=enc_warm)
            record("decode", case, 0.0,
                   device_ms(lambda i: compress.decode_kernel(*encs[i % sets], cols, bits),
                             calls, keep=True),
                   device_ms(lambda i: ref.decode_codec_ref(*encs[i % sets], shape, level),
                             calls, keep=True),
                   nbytes, 3.0 * rows * cols, path=(level == 2), warm_ms=dec_warm)
    print(f"[kernels] codec bit-exact on {len(codec_cases)} cases (words, scales, floats)")

    # ---------------------------------------------------------------- 4
    phase_launches = {}

    def run_phase(phase, fn):
        """Drive one main-path phase with the launch counts set to 0 just
        before it and read just after; every kernel of its path must run."""
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn(sayer(phase))
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
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
        offload_rates = {}
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
            assert st.payload_bytes == want, (st.payload_bytes, want)
            assert delta["exit_gate"] >= len(res)
            if level == 0:
                assert delta["encode"] == delta["decode"] == 0
            else:
                assert delta["encode"] >= 1 and delta["decode"] >= 1
        # the gate runs before the codec, so the level cannot move who offloads
        assert offload_rates[1, 0] == offload_rates[1, 1] == offload_rates[1, 2], offload_rates

    run_phase("serving", serving)

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
    run_phase("fleet", lambda say: fleet_phase(cuda, val_f, test_f, fleet_plans, say=say))

    # ---------------------------------------------------------------- 10
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
    sys.exit(main())
