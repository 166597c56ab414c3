#!/usr/bin/env python3
"""K5's checks of `chip_smoke.py` alone, on one card, then Qwen3-8B's
partitions with and without K5.

    python3 tools/k5_phase.py      # from the repo root

It builds the kernels, holds K5 against its plain chain at the benchmark's
shapes within one bf16 ulp and times both beside K5's bound
(`chip_smoke.qk_rope_checks`), then seeds Qwen3-8B at full width and depth
and runs its edge and cloud partitions under `torch.no_grad()` inside
`torch.cuda.set_sync_debug_mode("error")` (`chip_smoke.qk_rope_sync_check`).
Last, at 64 x 64 and 8 x 512 tokens, the edge partition on every row and
the cloud on half of them, as the offload engine calls them, in turns with
K5 and with the plain chain (`qk_rope.takes` made false): host ms of the
two calls to a sync (median of 10) and the launch calls a pair makes under
the profiler. Exits non-zero if a check fails.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k5_phase: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, qk_rope
    from repro_torch.models import registry, transformer

    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    own = False
    for line in _build.build_log().splitlines():  # ptxas on K5's source
        own = ("qk_rope.cu" in line) if line.startswith("$ ") else own
        if own and ("Used" in line or "spill" in line or "Compiling" in line):
            print("[build] " + line.strip())

    def say(msg, timed=False):
        print(msg + (f" [{smi}]" if timed else ""), flush=True)

    def record(kernel, case, err, ms, plain_ms, nbytes, flops, path=False):
        bms, by = cs.bound_ms(nbytes, flops)
        say(f"{kernel} {case}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
            f"{bms * 1e3:.2f} us ({by}, {bms / ms:.1%} of it)", timed=True)

    cs.qk_rope_checks(cuda, record, say)

    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = registry.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    torch.cuda.synchronize()
    say(f"{cfg.name} seeded in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=cuda).manual_seed(7)
    shapes = [(64, 64), (8, 512)]
    batches = [torch.randint(0, cfg.vocab_size, s, device=cuda, generator=gen) for s in shapes]
    cs.qk_rope_sync_check(cuda, cfg, params, batches, say)

    def pair(tokens):
        with torch.no_grad():
            edge = transformer.edge_forward(params, cfg, {"tokens": tokens}, exit_index=0)
            transformer.cloud_forward(params, cfg, edge["hidden"][:tokens.shape[0] // 2],
                                      exit_index=0)
        torch.cuda.synchronize()

    takes = qk_rope.takes
    plain = lambda q, k, positions: False  # noqa: E731
    for tokens in batches:
        times = {"K5": [], "plain": []}
        for _ in range(2):
            for arm in ("K5", "plain", "plain", "K5"):
                qk_rope.takes = takes if arm == "K5" else plain
                pair(tokens)  # warm
                for _ in range(5):
                    t1 = time.perf_counter()
                    pair(tokens)
                    times[arm].append(1e3 * (time.perf_counter() - t1))
        launches = {}
        for arm in ("K5", "plain"):
            qk_rope.takes = takes if arm == "K5" else plain
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pair(tokens)
            launches[arm] = sum(e.count for e in prof.key_averages()
                                if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                             "cuLaunchKernel", "cuLaunchKernelEx",
                                             "cudaMemcpyAsync", "cudaMemsetAsync"))
        qk_rope.takes = takes
        say(f"{tuple(tokens.shape)} tokens, edge + cloud on half the rows: K5 "
            f"{np.median(times['K5']):.2f} ms (quartiles {np.percentile(times['K5'], 25):.2f}-"
            f"{np.percentile(times['K5'], 75):.2f}), plain {np.median(times['plain']):.2f} ms "
            f"({np.percentile(times['plain'], 25):.2f}-{np.percentile(times['plain'], 75):.2f}); "
            f"launch calls {launches['K5']} / {launches['plain']}", timed=True)
    print('{"ok": true}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
