"""Port parity for checkpoints: `repro_torch.training.checkpoint` writes
and reads the reference's msgpack format, so a file written by either
package loads in the other, bit for bit (bfloat16 leaves as their uint16
patterns), and `repro_torch.launch.train` writes a file the reference's
`load` accepts."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_smoke as jget_smoke
from repro.models import registry as jregistry
from repro.training import checkpoint as jckpt
from repro.training import optim as joptim
from repro_torch.configs import get_smoke
from repro_torch.models import registry
from repro_torch.training import checkpoint, optim

SRC = Path(__file__).resolve().parents[1] / "src"


def _tree():
    """Every leaf kind a checkpoint holds: bf16 and float32 weights with
    keys out of sorted order, a list, an int32 scalar, an int64 vector."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    return {"z": {"w": w.to(torch.bfloat16), "b": torch.arange(5, dtype=torch.float32)},
            "a": [torch.tensor(7, dtype=torch.int32), torch.arange(4)],
            "m": torch.from_numpy(rng.standard_normal((2, 2, 2)).astype(np.float32))}


def _leaves_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                        y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(la, lb))


def test_round_trip_keeps_bits_dtypes_and_structure(tmp_path):
    tree = _tree()
    tree["z"]["w"][0, 0] = float("nan")  # a NaN's bits survive too
    path = str(tmp_path / "sub" / "ck.msgpack")
    checkpoint.save(path, tree)
    back = checkpoint.load(path, pytree.tree_map(torch.zeros_like, tree))
    assert list(back) == list(tree) and list(back["z"]) == list(tree["z"])
    assert _leaves_equal(back, tree)
    assert not [f for f in os.listdir(tmp_path / "sub") if f != "ck.msgpack"]  # no temp left


def test_optimizer_state_round_trips(tmp_path):
    params = {"w": torch.ones(2, 3, dtype=torch.bfloat16), "v": torch.ones(3)}
    state = optim.init(params)
    path = str(tmp_path / "opt.msgpack")
    checkpoint.save(path, state)
    back = checkpoint.load(path, state)
    assert isinstance(back, optim.OptState) and _leaves_equal(back, state)


def test_mismatched_shape_or_count_raises(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    checkpoint.save(path, {"w": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load(path, {"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="1 leaves, template 2"):
        checkpoint.load(path, {"w": torch.zeros(3, 3), "x": torch.zeros(1)})


def test_files_cross_between_packages(tmp_path):
    """A file saved by the reference loads in the port and one saved by
    the port loads in the reference, leaf for leaf and bit for bit: the
    smoke jamba's seeded bf16 params and AdamW state."""
    cfg = jget_smoke("jamba-v0.1-52b")
    jparams = jregistry.init_params(jax.random.PRNGKey(0), cfg)
    jtree = {"params": jparams, "opt": joptim.init(jparams), "step": jnp.int32(3)}
    jpath, tpath = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    jckpt.save(jpath, jtree)

    tparams = registry.init_params(torch.Generator().manual_seed(0), get_smoke("jamba-v0.1-52b"),
                                   device="cpu")
    template = {"params": tparams, "opt": optim.init(tparams),
                "step": torch.tensor(0, dtype=torch.int32)}
    got = checkpoint.load(jpath, template)
    assert int(got["step"]) == 3
    want = jax.tree.leaves(jtree)
    got_leaves = checkpoint._flatten(got)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
        if w.dtype == jnp.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16))
        else:
            assert np.array_equal(g.numpy(), w)

    checkpoint.save(tpath, got)
    back = jckpt.load(tpath, jtree)
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(back), want):
        assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                              np.asarray(b).reshape(-1).view(np.uint8))
    # the reference reads the port's own tree (keys in the port's order)
    tpath2 = str(tmp_path / "port2.msgpack")
    checkpoint.save(tpath2, template)
    back2 = jckpt.load(tpath2, jtree)
    for a, t in zip(jax.tree.leaves(back2), checkpoint._flatten(template)):
        ref = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert np.array_equal(np.asarray(a, ref.dtype), ref)


def test_launch_train_writes_a_checkpoint_the_reference_loads(tmp_path):
    """`python -m repro_torch.launch.train --smoke` on the CPU: three steps
    of the smoke mamba2-130m, logged as the reference logs them; the file
    loads in the reference's `load` against its own template."""
    path = str(tmp_path / "ck.msgpack")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "mamba2-130m", "--smoke", "--steps", "3", "--device", "cpu",
                          "--ckpt", path, "--log-every", "1"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=mamba2-130m-smoke params=")
    steps = [l for l in lines if l.startswith("step ")]
    assert len(steps) == 3 and all("loss_exit0=" in l and "gnorm=" in l for l in steps)
    assert lines[-1] == f"saved checkpoint to {path}"
    cfg = jget_smoke("mamba2-130m")
    template = {"params": jregistry.init_params(jax.random.PRNGKey(0), cfg),
                "step": jnp.int32(0)}
    back = jckpt.load(path, template)
    assert int(back["step"]) == 3
    assert all(np.isfinite(np.asarray(a, np.float32)).all() for a in jax.tree.leaves(back))


def test_launch_train_refuses_the_production_mesh():
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="one card has no 256- or 512-chip mesh"):
        train.main(["--arch", "olmo-1b", "--production-mesh", "--device", "cpu"])
