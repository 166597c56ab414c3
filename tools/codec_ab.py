#!/usr/bin/env python3
"""K3 encode and K4 decode of several checkouts in turns, on one card, to
compare versions of the codec kernels in one call.

    python3 tools/codec_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout holding `src/repro_torch`. Each runs
in a process of its own, in the order given: it builds that checkout's
kernels, holds its encode to its plain version bit for bit, and times
`compress.encode_kernel` and `decode_kernel` at the codec shapes of
`chip_smoke.py` phase 3 on the same seeded inputs, with phase 3's harness
(a CUDA graph of back-to-back calls between CUDA events): L2-cold for
payloads of 1 MB or more (inputs rotate over sets, every call writes fresh
outputs), L2-warm over 100 calls otherwise, beside a 1-element add_ as the
launch floor, and a strided copy that reads the same input and writes as
many bytes as the words (`x.view(-1, 32 // bits)[:, 0].clone()`, one
PyTorch launch): what a single launch moving these bytes costs in this
harness. Prints each run's lines, then one line a case with each run's
encode, decode and copy us in the order given. Exits non-zero if any run
fails.

With --layouts, each checkout instead times its encode in every layout
that `compress.ENCODE_LAYOUTS` offers a wide payload (quad and wide, 16-byte
aligned) at each block size of --threads, whatever `encode_layout` would
pick, on payloads from 128 to 65 536 (row, group) pairs at int8 and int4,
each held to the plain version bit for bit, and the strided copy beside
them. It prints the ptxas register counts of the encode kernels, then one
JSON line a case.
"""
import json
import os
import subprocess
import sys

HARNESS = r"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src"]
import numpy as np
import torch
from repro_torch.kernels import compress, ref

assert torch.cuda.is_available(), "the codec kernels run on the card"
cuda = torch.device("cuda")


def device_us(fn, calls, keep):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph, held = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(calls):
            out = fn(i)
            if keep:
                held.append(out)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls * 1e3)
    del graph, held
    torch.cuda.synchronize()
    return float(np.median(times))


one = torch.zeros(1, device=cuda)
warm_up = torch.randn(64 << 20, device=cuda)
for _ in range(30):
    warm_up.mul_(1.0)  # bring the clocks up before the first timing
del warm_up
floor = device_us(lambda i: one.add_(1), 100, False)


def plan(nbytes):
    cold = nbytes >= 1e6
    sets = max(2, -(-int(100e6) // nbytes) + 1) if cold else 1
    return cold, sets, (-(-max(20, sets) // sets) * sets if cold else 100)
"""

CHILD = HARNESS + r"""
CASES = [((512, 16, 16, 64), 1), ((512, 16, 16, 64), 2), ((1, 16, 16, 64), 1),
         ((1, 16, 16, 64), 2), ((1, 8, 8, 96), 1), ((1, 8, 8, 96), 2), ((2048, 10), 2),
         ((252, 16, 16, 64), 1), ((252, 16, 16, 64), 2), ((256, 8, 8, 96), 1),
         ((256, 8, 8, 96), 2), ((252, 8, 8, 96), 1), ((252, 8, 8, 96), 2), ((3, 700), 1),
         ((3, 700), 2), ((5, 301), 1), ((5, 301), 2), ((1024, 10), 2), ((4096, 10), 1),
         ((4096, 10), 2), ((3000, 10), 1), ((3000, 10), 2), ((7000, 10), 1), ((7000, 10), 2),
         ((4, 2_097_152), 1), ((4, 2_097_152), 2), ((4, 786_432), 1), ((4, 786_432), 2)]
for shape, level in CASES:
    bits = ref.CODEC_BITS[level]
    rows, cols = ref._codec_layout(shape)
    gen = np.random.default_rng(rows * 7 + cols + level)
    nbytes = rows * cols * 4 + -(-cols // 128) * rows * (128 * bits // 8 + 4)
    cold, sets, calls = plan(nbytes)
    xs = [torch.as_tensor((gen.standard_normal((rows, cols)) * 3).astype(np.float32), device=cuda)
          for _ in range(sets)]
    encs = [compress.encode_kernel(x, bits) for x in xs]
    rw, rs = ref.encode_codec_ref(xs[0], level)
    assert torch.equal(encs[0][0].view(torch.int32), rw.view(torch.int32)), (shape, level)
    assert torch.equal(encs[0][1].view(torch.int32), rs.view(torch.int32)), (shape, level)
    enc = device_us(lambda i: compress.encode_kernel(xs[i % sets], bits), calls, cold)
    dec = device_us(lambda i: compress.decode_kernel(*encs[i % sets], cols, bits), calls, cold)
    k = 32 // bits
    n = rows * cols - rows * cols % k
    copy = device_us(lambda i: xs[i % sets].view(-1)[:n].view(-1, k)[:, 0].clone(), calls, cold)
    print(json.dumps(dict(case=f"{shape} level {level}", cold=cold, enc_us=enc, dec_us=dec,
                          copy_us=copy, bound_us=nbytes / 3.35e12 * 1e6, floor_us=floor)),
          flush=True)
"""

LAYOUTS = HARNESS + r"""
from repro_torch.kernels import _build

threads = [int(t) for t in sys.argv[2].split(",")]
compress.encode_kernel(torch.zeros(1, 128, device=cuda), 8)  # builds the library
log = _build.build_log().splitlines()
for i, line in enumerate(log):
    if "Compiling entry function" in line and "encode" in line:
        used = next((x for x in log[i + 1:i + 4] if "registers" in x), "")
        print("ptxas", line.split("'")[1], used.split(":", 1)[-1].strip(), flush=True)
SHAPES = [(1, 16384), (8, 16384), (32, 16384), (48, 16384), (64, 16384), (252, 6144),
          (256, 6144), (128, 16384), (4, 786_432), (252, 16384), (512, 16384),
          (4, 2_097_152)]
for rows, cols in SHAPES:
    groups = -(-cols // 128)
    pairs = rows * groups
    gen = np.random.default_rng(rows * 7 + cols)
    for level in (1, 2):
        bits = ref.CODEC_BITS[level]
        nbytes = rows * cols * 4 + pairs * (128 * bits // 8 + 4)
        cold, sets, calls = plan(nbytes)
        xs = [torch.as_tensor((gen.standard_normal((rows, cols)) * 3).astype(np.float32),
                              device=cuda) for _ in range(sets)]
        rw, rs = ref.encode_codec_ref(xs[0], level)

        def launch(x, kind, t):
            words = torch.empty((rows, groups * 128 * bits // 32), dtype=torch.uint32, device=cuda)
            scales = torch.empty((rows, groups), dtype=torch.float32, device=cuda)
            warps = pairs if kind == "quad" else -(-pairs // 2)
            blocks = min(-(-warps * 32 // t), compress.MAX_BLOCKS)
            compress.ENCODE(cuda, x.data_ptr(), rows, cols, bits, words.data_ptr(),
                            scales.data_ptr(), compress.ENCODE_LAYOUTS.index(kind), t, blocks)
            return words, scales

        row = dict(shape=[rows, cols], pairs=pairs, level=level, cold=cold,
                   bound_us=nbytes / 3.35e12 * 1e6, floor_us=floor, us={})
        for kind in ("quad", "wide"):
            for t in threads:
                w, sc = launch(xs[0], kind, t)
                assert torch.equal(w.view(torch.int32), rw.view(torch.int32)), (rows, cols, kind, t)
                assert torch.equal(sc.view(torch.int32), rs.view(torch.int32)), (rows, cols, kind, t)
                row["us"][f"{kind} t{t}"] = device_us(
                    lambda i: launch(xs[i % sets], kind, t), calls, cold)
        row["us"]["strided copy"] = device_us(
            lambda i: xs[i % sets].view(-1, 32 // bits)[:, 0].clone(), calls, cold)
        row["picked"] = compress.encode_layout(rows, cols, True).kind
        print(json.dumps(row), flush=True)
"""


def main(args) -> int:
    layouts = "--layouts" in args
    threads = "128,256"
    if "--threads" in args:
        threads = args[args.index("--threads") + 1]
        args = args[:args.index("--threads")] + args[args.index("--threads") + 2:]
    roots = [a for a in args if a != "--layouts"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    failed, table = 0, {}
    for i, root in enumerate(roots):
        root = os.path.abspath(root)
        cmd = [sys.executable, "-c", LAYOUTS, root, threads] if layouts else \
            [sys.executable, "-c", CHILD, root]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"[{i} {root}] {line}", flush=True)
            if line.startswith("{") and not layouts:
                row = json.loads(line)
                table.setdefault(row["case"], [row]).append(row)
        failed += proc.returncode != 0
    for case, (first, *runs) in table.items():
        print(f"{case} ({'L2-cold' if first['cold'] else 'L2-warm'}; bound "
              f"{first['bound_us']:.2f} us, floor {first['floor_us']:.2f} us): encode "
              + " ".join(f"{r['enc_us']:.2f}" for r in runs) + "; decode "
              + " ".join(f"{r['dec_us']:.2f}" for r in runs) + "; strided copy "
              + " ".join(f"{r['copy_us']:.2f}" for r in runs), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
