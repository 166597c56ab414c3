"""The comparison that decides ``correct`` has teeth, at the configurations'
smoke sizes on the CPU:

* the port's runs read correct;
* the control (the plain reference in the program's place, one precision
  below the configuration's: TF32 for B-AlexNet's float32, fp8 for
  Qwen3's bf16) reads not correct, on three seeds each;
* a run with the timed path broken underneath (an answer altered where it
  is produced; half of each batch left out, its answers copied from the
  other half) reads not correct.

On the card, ``python3 bench/control.py --workload <cell> --seeds ...``
runs the control at the cell's own size, and with ``--fault`` the port
with a fault planted; the marked tests below do so.
"""
import subprocess
import sys

import pytest

from benchkit import faults, runner

CELLS = ["b_alexnet.br1-offload-half", "qwen3-8b.exit0-s512-offload-half"]
SEEDS = [2**31 + 11, 2**31 + 12, 2**31 + 13]


def _run(root, cell, seed, **kw):
    result, _ = runner.run(root, cell, seed, 0.2, False, device="cpu", smoke=True, **kw)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_port_reads_correct(root, cell):
    result = _run(root, cell, SEEDS[0])
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(root, cell, seed):
    from benchkit.manifest import Manifest

    precision = Manifest(root).cell(cell).config["control_precision"]
    result = _run(root, cell, seed, control=precision, min_batches=3)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_reads_not_correct(root, cell, fault):
    undo = faults.plant(fault)
    try:
        result = _run(root, cell, SEEDS[1])
    finally:
        undo()
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS + ["b_alexnet.br1-offload-tenth",
                                          "qwen3-8b.exit0-s64-offload-half"])
def test_control_on_the_card(root, card, cell):
    out = subprocess.run([sys.executable, str(root / "bench" / "control.py"), "--workload", cell,
                          "--seeds", "3000000021,3000000022,3000000023"],
                         capture_output=True, text=True, timeout=1800, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [line for line in out.stdout.splitlines() if '"side": "control"' in line]
    assert len(runs) == 3 and all('"correct": false' in line for line in runs)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS + ["b_alexnet.br1-offload-tenth",
                                          "qwen3-8b.exit0-s64-offload-half"])
def test_altered_answer_on_the_card(root, card, cell):
    out = subprocess.run([sys.executable, str(root / "bench" / "control.py"), "--workload", cell,
                          "--seeds", "3000000024,3000000025,3000000026",
                          "--fault", "answer_altered"],
                         capture_output=True, text=True, timeout=1800, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [line for line in out.stdout.splitlines() if '"side": "answer_altered"' in line]
    assert len(runs) == 3 and all('"correct": false' in line for line in runs)
