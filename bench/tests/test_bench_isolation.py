"""What a run loads, checked in fresh interpreters (this one may hold JAX):

* a whole run of each configuration (the harness, the port, the plain
  references, every metric reader) loads nothing whose top-level name is
  ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared whole: the port's
  name begins with the JAX package's);
* the plain references and what they import load no ``repro_torch`` either;
* a checkout that holds only ``BENCHMARK.json`` and ``bench/`` runs no cell
  and prints no result.
"""
import json
import os
import shutil
import subprocess
import sys

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code, root, env=None, path=True):
    env = dict(os.environ if env is None else env)
    env.pop("PYTHONPATH", None)
    prelude = (f"import sys; sys.path[:0] = [{str(root / 'bench')!r}"
               + (f", {str(root / 'src')!r}" if path else "") + "]\n")
    return subprocess.run([sys.executable, "-c", prelude + code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=root)


def _top_levels(stdout):
    return set(json.loads(stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(root):
    code = (
        "import json, pathlib\n"
        "from benchkit import runner\n"
        "from benchkit.manifest import Manifest\n"
        "root = pathlib.Path(sys.path[0]).parent\n"
        "for cell in ('b_alexnet.br1-offload-half', 'qwen3-8b.exit0-s64-offload-half'):\n"
        "    runner.run(root, cell, 2**31 + 303, 0.1, True, device='cpu', smoke=True)\n"
        "m = Manifest(root)\n"
        "for name in m.names('workloads'):\n"
        "    c = m.cell(name)\n"
        "    for part in ('model', 'reference', 'flops'):\n"
        "        c.module(part)\n"
        "    for metric in c.metrics_e2e + c.metrics_layer:\n"
        "        c.metric_reader(metric['name'])\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = _python(code, root)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = _top_levels(out.stdout)
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_references_load_nothing_of_either_package(root):
    code = (
        "import json, pathlib\n"
        "from benchkit import judge, precision, seeds\n"
        "from benchkit.manifest import Manifest\n"
        "m = Manifest(pathlib.Path(sys.path[0]).parent)\n"
        "for name in m.names('workloads'):\n"
        "    m.cell(name).module('reference')\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = _python(code, root, path=False)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = _top_levels(out.stdout)
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded & (FORBIDDEN | {"repro_torch"})


def test_benchmark_files_alone_run_nothing(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json, pathlib\n"
            "from benchkit import runner\n"
            "r, _ = runner.run(pathlib.Path(sys.path[0]).parent, 'b_alexnet.br1-offload-half', 1,"
            " 0.1, False, device='cpu', smoke=True)\n"
            "print(json.dumps(r))\n")
    out = _python(code, tmp_path, path=False)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
