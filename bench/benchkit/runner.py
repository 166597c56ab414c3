"""One run of one cell: set-up, the measured window, the trace, the check
and the result line.

Set-up makes the weights and the inputs on the device from the seed and
calibrates: labels planted from the plain reference's float32 exit on the
validation rows at `PLANT_TEMPERATURE`, the temperature fitted by the side
in the program's place, ``p_tar`` at the workload's ``quantile`` of the
calibrated exit confidences. The reference's pass is timed apart and left
out of ``setup_s`` and of the peak memory. Then it warms up: a few batches
through `infer`, then the cloud partition at every refused count m the
window can plausibly draw (`WARM_SD` standard deviations around the rate
seen), so that no per-shape set-up falls inside the window.

The window is a closed loop with one caller: batch k is drawn on the
device from (seed, k) and goes through `infer`, back to back, until
``seconds`` have passed. Once it has closed, the peak memory is read, the
program's state is dropped, and the plain reference judges a sample of the
served batches, drawn from the seed (`benchkit.judge`).
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchkit import judge, peaks, seeds
from benchkit import trace as tracing
from benchkit.manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN = tracing.PREFIX
#: the temperature of the softmax the calibration labels are drawn from:
#: an overconfident exit, which calibration corrects (the paper's premise)
PLANT_TEMPERATURE = 1.5
#: the refused counts the cloud is warmed at: this many standard deviations
#: either side of the warm-up batches' rate
WARM_SD = 4


def forbidden_modules() -> List[str]:
    """Top-level names in `sys.modules` that the port must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(on: bool):
    return torch.profiler.record_function if on else (lambda name: contextlib.nullcontext())


def plant_labels(logits, temperature: float, gen: torch.Generator):
    """One label per row drawn from softmax(z / temperature), by inverse CDF
    on uniforms from `gen`."""
    cdf = torch.softmax(logits.to(torch.float64) / temperature, dim=-1).cumsum(dim=-1)
    u = torch.rand(cdf.shape[0], generator=gen, device=gen.device, dtype=torch.float64)
    y = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None])[:, 0]
    return y.clamp(max=cdf.shape[1] - 1)


def quantile_threshold(conf, q: float) -> float:
    """The midpoint of the two order statistics around quantile q."""
    c = torch.sort(conf.to(torch.float64))[0]
    k = min(max(int(round(q * len(c))), 1), len(c) - 1)
    return float((c[k - 1] + c[k]) / 2)


class Port:
    """The program: the port's engine, calibrated by K2."""

    payload = None

    def __init__(self, model, weights, spec, work, device):
        from repro_torch.core.calibration import TemperatureScaling
        from repro_torch.core.policy import OffloadPlan

        self.index = model.plan_index(spec)
        self._plan = lambda t, p: OffloadPlan(
            p_tar=p, calibrators=[TemperatureScaling.from_temperature(t)] * (self.index + 1),
            exit_index=self.index, compression_level=work["codec_level"])
        self.engine = model.engine(weights, spec, self._plan(1.0, 1.0), work, device)

    def exit_logits(self, inputs):
        with torch.no_grad():
            return self.engine.edge_fn(inputs)["exit_logits"]

    def fit(self, z, y) -> float:
        from repro_torch.kernels import ops

        return float(ops.fit_temperature_kernel(z, y)[0])

    def deploy(self, temperature: float, p_tar: float):
        self.engine.plan = self._plan(temperature, p_tar)

    def serve(self, inputs) -> Dict[str, np.ndarray]:
        return self.engine.infer(inputs)

    def warm(self, inputs, refused: List[int], b: int):
        """The cloud partition at every m within `WARM_SD` standard
        deviations of the refused rate the warm-up batches showed. Keeps the
        payload's leaves (shape of a row, dtype, bytes a row)."""
        from torch.utils._pytree import tree_leaves, tree_map

        r = sum(refused) / (len(refused) * b)
        sd = math.sqrt(b * r * (1 - r))
        lo, hi = max(1, math.floor(b * r - WARM_SD * sd)), min(b, math.ceil(b * r + WARM_SD * sd))
        with torch.no_grad():
            payload = self.engine.edge_fn(inputs)["payload"]
            self.payload = [{"shape": list(x.shape[1:]), "dtype": str(x.dtype).split(".")[-1],
                             "bytes_per_row": x[0].numel() * x.element_size()}
                            for x in tree_leaves(payload)]
            for m in range(lo, hi + 1):
                if m not in refused:
                    self.engine.cloud_fn(tree_map(lambda x: x[:m], payload))
        return hi - lo + 1

    def traced(self):
        """Spans around the calls into each partition."""
        eng = self.engine
        for tier in ("edge", "cloud"):
            fn = getattr(eng, f"{tier}_fn")

            def wrapped(x, fn=fn, name=SPAN + tier):
                with torch.profiler.record_function(name):
                    return fn(x)
            setattr(eng, f"{tier}_fn", wrapped)

    def stats(self) -> Dict:
        s = self.engine.stats
        return {k: getattr(s, k) for k in ("requests", "on_device", "offloaded", "payload_bytes",
                                           "edge_calls", "cloud_calls", "edge_time_s",
                                           "cloud_time_s")}


class Control:
    """The plain reference put in the program's place at a lower precision."""

    payload = None

    def __init__(self, reference, weights, spec, precision):
        self.forward = lambda x, final: reference.forward(weights, spec, x, final, precision)

    def _rows(self, inputs, value):
        x = next(iter(inputs.values()))
        return torch.full((x.shape[0],), value, dtype=torch.bool, device=x.device)

    def exit_logits(self, inputs):
        return self.forward(inputs, self._rows(inputs, False))[0]

    def fit(self, z, y) -> float:
        return judge.fit_temperature(z, y)

    def deploy(self, temperature, p_tar):
        self.t, self.p_tar = temperature, p_tar

    def serve(self, inputs):
        e, f = self.forward(inputs, self._rows(inputs, True))
        ce = judge.confidence(e, self.t)
        on = ce >= self.p_tar
        pred = torch.where(on, e.argmax(-1), f.argmax(-1))
        conf = torch.where(on, ce, judge.confidence(f))
        return {"prediction": pred.cpu().numpy(), "confidence": conf.float().cpu().numpy(),
                "on_device": on.cpu().numpy()}

    def stats(self):
        return None


def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, smoke: bool = False, control: Optional[str] = None,
        min_batches: int = 0):
    """Run `cell_name` once. Returns (result, lines): the result line's
    object and the check lines for standard error.

    `control` puts the plain reference at that precision in the program's
    place (no warm-up); `smoke` takes the configuration's and the
    workload's ``smoke`` sizes (tests on the CPU)."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = {"import": time.perf_counter() - t0}
    device = torch.device(device)
    cell = Manifest(root).cell(cell_name)
    model, reference, flops = (cell.module(p) for p in ("model", "reference", "flops"))
    spec = model.spec(cell.config, smoke)
    work = {k: v for k, v in cell.traffic.items() if k != "smoke"}
    work.update(cell.traffic.get("smoke", {}) if smoke else {})
    limits = cell.config["limits"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = work["batch"]

    def gen(stream, k=0):
        return seeds.generator(seed, stream, k, device)

    def mark(phase, since):
        _sync(device)
        phases[phase] = time.perf_counter() - since
        return time.perf_counter()

    a = time.perf_counter()
    weights = model.make_weights(gen("weights"), spec, device)
    state = model.make_data(gen("data"), spec, device)

    def draw(stream, k, n=b):
        return model.draw(state, gen(stream, k), n, work, spec)

    a = mark("weights", a)
    # ---- labels: planted from the plain reference's float32 exit on the
    # validation rows, where the reference also fits its own temperature;
    # timed apart, and its memory freed and left out of the peak
    n_val, step = work["val_rows"], work["calib_batch"]
    n_q = max(n_val, work["quantile_rows"])
    every = draw("validation", 0, n_q)
    ref_val, _ = reference.forward(weights, spec, model.rows(every, slice(0, n_val)),
                                   torch.zeros(n_val, dtype=torch.bool, device=device))
    labels = plant_labels(ref_val, PLANT_TEMPERATURE, gen("labels"))
    t_ref = judge.fit_temperature(ref_val, labels)
    del ref_val
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    a = mark("reference", a)

    # ---- calibration: the side in the program's place fits T on the
    # validation rows and those labels; p_tar at the workload's quantile of
    # the calibrated exit confidences of those rows and more
    # (``quantile_rows``, so that the rate refused in the window is the
    # quantile's on every seed)
    side = (Port(model, weights, spec, work, device) if control is None
            else Control(reference, weights, spec, control))
    z = torch.cat([side.exit_logits(model.rows(every, slice(i, i + step)))
                   for i in range(0, n_q, step)])
    del every
    t_side = side.fit(z[:n_val], labels)
    p_tar = quantile_threshold(torch.cat([judge.confidence(c, t_side) for c in z.split(256)]),
                               work["quantile"])
    classes = z.shape[1]
    del z
    side.deploy(t_side, p_tar)
    a = mark("calibration", a)

    # ---- warm-up: the cell's own shapes, the cloud at every likely m
    warmed = 0
    if control is None:
        refused = [int((~side.serve(draw("warmup", k))["on_device"]).sum())
                   for k in range(work["warm_batches"])]
        warmed = side.warm(draw("warmup", 0), refused, b)
        side.engine.stats = type(side.engine.stats)()
        if trace:
            side.traced()
    gc.collect()
    mark("warmup", a)
    setup_s = time.perf_counter() - t0 - phases["reference"]

    # ---- the window
    span = _span(trace)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if trace else contextlib.nullcontext()
    latencies, outs = [], []
    with prof:
        with span(SPAN + "window"):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds or len(outs) < min_batches:
                with span(SPAN + "draw"):
                    inputs = draw("window", len(outs))
                a = time.perf_counter()
                with span(SPAN + "infer"):
                    out = side.serve(inputs)
                latencies.append(time.perf_counter() - a)
                outs.append(out)
            end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    reduced = tracing.reduce(prof.profiler.kineto_results.events()) if trace else None
    refused = [int((~o["on_device"]).sum()) for o in outs]
    edge_f, cloud_f = flops.per_row(spec, work)
    record = {
        "setup_s": setup_s, "window_s": end - start, "batches": len(outs),
        "samples": b * len(outs), "latencies_s": latencies, "stats": side.stats(),
        "flops": float(sum(b * edge_f + m * cloud_f for m in refused)),
        "peak_flops": peaks.FLOPS[spec["dtype"]], "trace": reduced,
        "rows": b, "classes": classes, "logit_bytes": model.LOGIT_BYTES, "payload": side.payload,
    }
    del side, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check: the plain reference on a sample of the served batches
    # drawn from the seed (its temperature was fitted at set-up)
    rng = seeds.numpy_rng(seed, "check")
    chosen = sorted(rng.choice(len(outs), size=min(work["check_batches"], len(outs)),
                               replace=False).tolist())
    per_call = max(1, model.CHECK_ROWS // b)
    parts, counts = [], {"judged": 0, "near": 0, "bad": 0}
    for i in range(0, len(chosen), per_call):
        group = chosen[i:i + per_call]
        inputs = [draw("window", k) for k in group]
        inputs = {key: torch.cat([x[key] for x in inputs]) for key in inputs[0]}
        port = {key: torch.as_tensor(np.concatenate([outs[k][key] for k in group]), device=device)
                for key in ("prediction", "confidence", "on_device")}
        ref_exit, ref_final = reference.forward(weights, spec, inputs, ~port["on_device"])
        numbers, rows = judge.compare(port, ref_exit, ref_final, t_side, t_ref, p_tar, limits)
        parts.append(numbers)
        counts = {k: counts[k] + rows[k] for k in counts}
    checks = judge.merge(parts)
    correct = all(checks[k] <= limits[k] for k in judge.NAMES)

    metrics = {}
    for m in cell.metrics_layer if trace else cell.metrics_e2e:
        value = cell.metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": record["samples"],
              "failed": counts["bad"], "metrics": metrics, "device": dev}
    if reduced is not None:
        dev["busy_s"], dev["window_s"] = reduced["busy_s"], reduced["window_s"]
        result["breakdown"] = tracing.breakdown(reduced)
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in judge.NAMES}
    lines = [f"info: seed {seed}, {record['batches']} batches of {b} in {record['window_s']:.3f} s, "
             f"set-up {setup_s:.3f} s ({warmed} refused counts warmed), T {t_side:.9g} (reference "
             f"{t_ref:.9g}), p_tar {p_tar:.9g}, {b * len(chosen)} rows checked in "
             f"{len(chosen)} batches, the route judged on {counts['judged']} of them (outside "
             f"the conf_exit_rel margin), {counts['near']} within a relative 1e-6 of p_tar",
             "info: set-up phases s " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
             + " (the reference's labels left out of set-up)"]
    lat = np.percentile(np.array(latencies) * 1e3, [50, 90, 95, 99, 100])
    lines.append("info: infer ms p50 {:.3f} p90 {:.3f} p95 {:.3f} p99 {:.3f} max {:.3f}; refused a "
                 "batch {} to {}, mean {:.2f}".format(*lat, min(refused), max(refused),
                                                      float(np.mean(refused))))
    lines += [f"check: {k} {checks[k]!r} limit {limits[k]!r}" for k in judge.NAMES]
    return result, lines
