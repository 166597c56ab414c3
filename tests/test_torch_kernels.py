"""Port parity for the four kernels: the plain PyTorch versions in
`repro_torch.kernels` (the CPU path of every kernel wrapper) against the
reference's Pallas kernels in interpret mode and its oracles.

The same numpy inputs, made from a seed, go through both packages.
Tolerances: K1 conf rtol 2e-5 / atol 1e-6, entropy rtol 2e-5 / atol
2e-5, argmax exact (as `test_kernels.py`); K2 NLL rtol 1e-5 / atol 1e-6,
dNLL/dT rtol 5e-3 / atol 1e-5, d2NLL/dT2 rtol 5e-3 / atol 1e-3, the
kernel Newton fit within 0.05; the codec bit-exact on words, scales and
decoded floats.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import compress as jcompress
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import calib_nll as tcalib_nll
from repro_torch.kernels import compress as tcompress
from repro_torch.kernels import exit_gate as texit_gate
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _release_interpret_executables():
    """Drop the interpret-mode executables this module compiles (one per
    shape) at teardown, as `test_compress.py` does."""
    yield
    jax.clear_caches()


def _rand(shape, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _u32(t):
    return t.numpy().astype(np.uint32)


# ------------------------------------------------------------------ K1
def _assert_gate_close(got, want):
    conf, pred, ent = (np.asarray(x.float() if isinstance(x, torch.Tensor) else x) for x in got)
    rconf, rpred, rent = (np.asarray(x) for x in want)
    np.testing.assert_allclose(conf, rconf, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ent, rent, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(pred, rpred)


@pytest.mark.parametrize("shape,temp", [
    ((1, 10), 1.0),
    ((17, 700), 0.25),
    ((64, 10), 2.0),      # the serving gate's class count
    ((2, 3, 130), 1.3),   # leading dims
    # the edges of the CUDA kernel's layouts (lane groups up to 32 columns,
    # a warp per row up to 1024, a block per row above), odd widths that
    # leave rows unaligned, and fewer rows than a block holds
    ((3, 1), 1.3),
    ((5, 32), 1.3),
    ((5, 33), 1.3),
    ((3, 1025), 1.3),
    ((4, 4097), 1.3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exit_gate_plain_matches_pallas(shape, temp, dtype):
    z = _rand(shape, seed=sum(shape), scale=6.0)
    zj = jnp.asarray(z).astype(dtype)
    zt = torch.as_tensor(z).to(getattr(torch, dtype))
    got = tops.exit_gate(zt, temp)
    assert got[1].dtype == torch.int32 and got[0].shape == shape[:-1]
    _assert_gate_close(got, jops.exit_gate(zj, temp))
    rconf, rent, ridx = jref.exit_gate_ref(zj, temp)
    _assert_gate_close(got, (rconf, ridx, rent))


def test_exit_gate_extreme_logits_and_ties():
    z = np.zeros((3, 128), np.float32)
    z[0, :4] = [1e4, -1e4, 0.0, 500.0]
    z[1, [5, 9]] = 7.0          # a tie: the first index wins
    z[2, :] = -1e4
    conf, pred, ent = tops.exit_gate(torch.as_tensor(z), 1.0)
    assert torch.isfinite(conf).all() and torch.isfinite(ent).all()
    assert pred.tolist() == [0, 5, 0]
    np.testing.assert_allclose(conf[0].item(), 1.0, atol=1e-6)
    _assert_gate_close((conf, pred, ent), jops.exit_gate(jnp.asarray(z), 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exit_gate_cross_warp_tie(dtype):
    """Row 3 ties at columns 7 and 4000 of an 8193-wide row: in the kernel's
    block-per-row layout they fall to different warps, and the lower index
    must win the merge. Row 4 holds x1 < x2, neighbouring float32 values
    whose quotients by T round to one value: the argmax is over z/T, so
    x1's lower column wins."""
    z = _rand((5, 8193), seed=12, scale=6.0)
    z[3, [7, 4000]] = 50.0
    xs = (np.float32(42.0).view(np.uint32) + np.arange(64, dtype=np.uint32)).view(np.float32)
    q = xs / np.float32(1.3)
    k = int(np.flatnonzero(q[:-1] == q[1:])[0])
    z[4, [104, 3148]] = xs[k], xs[k + 1]
    zt = torch.as_tensor(z).to(getattr(torch, dtype))
    got = tops.exit_gate(zt, 1.3)
    assert got[1][3:].tolist() == [7, 104]
    _assert_gate_close(got, jops.exit_gate(jnp.asarray(z).astype(dtype), 1.3))
    rconf, rent, ridx = jref.exit_gate_ref(jnp.asarray(z).astype(dtype), 1.3)
    _assert_gate_close(got, (rconf, ridx, rent))


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("rows,vocab", [(5, 130), (37, 700), (2000, 10)])
@pytest.mark.parametrize("temp", [0.5, 2.7])
def test_calib_stats_plain_matches_pallas(rows, vocab, temp):
    rng = np.random.default_rng(rows * 131 + vocab)
    z = (rng.standard_normal((rows, vocab)) * 4).astype(np.float32)
    y = rng.integers(0, vocab, rows).astype(np.int32)
    n, d1, d2 = tops.calib_stats(torch.as_tensor(z), torch.as_tensor(y), temp)
    jn, jd1, jd2 = jops.calib_stats(jnp.asarray(z), jnp.asarray(y), temp)
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(d1), float(jd1), rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(float(d2), float(jd2), rtol=5e-3, atol=1e-3)
    for a, b in zip(tref.calib_nll_ref(torch.as_tensor(z), torch.as_tensor(y), temp),
                    jref.calib_nll_ref(jnp.asarray(z), jnp.asarray(y), temp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


def _assert_calib_close(got, want):
    for a, b, tol in zip(got, want, [dict(rtol=1e-5, atol=1e-6), dict(rtol=5e-3, atol=1e-5),
                                     dict(rtol=5e-3, atol=1e-3)]):
        np.testing.assert_allclose(float(a), float(b), **tol)


# the edges of the CUDA kernel's layouts, as for K1: lane groups up to 32
# columns, a warp per row up to 1024, a block per row above; odd widths
# leave rows unaligned
@pytest.mark.parametrize("rows,vocab", [(3, 1), (5, 32), (5, 33), (3, 1024), (3, 1025),
                                        (4, 4097)])
@pytest.mark.parametrize("temp", [0.5, 2.7])
def test_calib_stats_layout_edges_match_pallas(rows, vocab, temp):
    rng = np.random.default_rng(rows * 7919 + vocab)
    z = (rng.standard_normal((rows, vocab)) * 4).astype(np.float32)
    y = rng.integers(0, vocab, rows).astype(np.int32)
    got = tops.calib_stats(torch.as_tensor(z), torch.as_tensor(y), temp)
    _assert_calib_close(got, jops.calib_stats(jnp.asarray(z), jnp.asarray(y), temp))


@pytest.mark.parametrize("rows,vocab", [(2000, 10), (3, 1025)])
def test_calib_stats_bf16_matches_pallas(rows, vocab):
    """One bfloat16 array through both packages: the Pallas kernel casts
    in its body, the port's plain path casts before it."""
    rng = np.random.default_rng(rows + vocab)
    z = torch.as_tensor((rng.standard_normal((rows, vocab)) * 4).astype(np.float32))
    zb = z.to(torch.bfloat16)
    y = rng.integers(0, vocab, rows).astype(np.int32)
    zj = jnp.asarray(zb.float().numpy()).astype(jnp.bfloat16)
    got = tops.calib_stats(zb, torch.as_tensor(y), 1.7)
    _assert_calib_close(got, jops.calib_stats(zj, jnp.asarray(y), 1.7))


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("kernel", [texit_gate.KERNEL, tcalib_nll.KERNEL, tcompress.ENCODE,
                                    tcompress.DECODE], ids=lambda k: k.name)
def test_launcher_argtypes_match_c_interface(kernel):
    """Each ctypes binding lists the exported C function's parameters, in
    order: a pointer as c_void_p, an int as c_int, a float as c_float."""
    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    found = re.findall(r'extern "C" int ' + kernel.symbol + r"\(([^)]*)\)", text)
    assert len(found) == 1, f"{kernel.symbol} is not exported once"
    params = [" ".join(p.split()) for p in found[0].split(",")]
    want = [ctypes.c_void_p if "*" in p else _C_TYPES[p.rsplit(" ", 1)[0]] for p in params]
    assert kernel.argtypes == want, (params, kernel.argtypes)


def test_fit_temperature_kernel_matches_reference():
    """Planted T* = 2.5 at the serving path's calibration shape."""
    rng = np.random.default_rng(8)
    z = (rng.standard_normal((2000, 10)) * 3).astype(np.float32)
    p = np.exp(z / 2.5)
    p /= p.sum(1, keepdims=True)
    y = (p.cumsum(1) > rng.random((2000, 1))).argmax(1).astype(np.int32)
    t, nll = tops.fit_temperature_kernel(torch.as_tensor(z), torch.as_tensor(y))
    tj, nj = jops.fit_temperature_kernel(jnp.asarray(z), jnp.asarray(y))
    assert abs(float(t) - float(tj)) < 0.05
    assert 2.2 < float(t) < 2.9
    np.testing.assert_allclose(float(nll), float(nj), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- K3 / K4
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("shape", [
    (4, 256, 13, 13),   # branch-1 style conv payload
    (8, 1536),          # aligned 2D
    (3, 700),           # ragged rows and cols
    (130,),             # 1D payload -> single row
    (5, 301),           # cols % 4 != 0: rows not 16-byte aligned
    (252, 8, 8, 96),    # branch 2's payload at a served refused size
])
def test_codec_plain_bitexact_with_reference(level, shape):
    x = _rand(shape, seed=level * 101 + len(shape))
    enc = tcompress.encode(torch.as_tensor(x), level)
    words, scales = jref.encode_codec_ref(x, level)
    np.testing.assert_array_equal(_u32(enc.words), words)
    np.testing.assert_array_equal(enc.scales.numpy(), scales)
    jenc = jcompress.encode(x, level)
    np.testing.assert_array_equal(_u32(enc.words), np.asarray(jenc.words))
    np.testing.assert_array_equal(enc.scales.numpy(), np.asarray(jenc.scales))
    assert enc.nbytes == jenc.nbytes
    out = tcompress.decode(enc)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    want = jref.decode_codec_ref(words, scales, x.shape, level)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jcompress.decode(jenc)))


@pytest.mark.parametrize("level", [1, 2])
def test_codec_zero_groups_and_nonfinite(level):
    x = np.zeros((8, 512), np.float32)
    x[:, 256:] = _rand((8, 256), seed=3)  # half the groups are live
    x[0, 300] = np.inf
    x[3, 400] = -np.inf
    x[7, 500] = np.nan
    enc = tcompress.encode(torch.as_tensor(x), level)
    words, scales = jref.encode_codec_ref(x, level)
    np.testing.assert_array_equal(_u32(enc.words), words)
    np.testing.assert_array_equal(enc.scales.numpy(), scales)
    assert (enc.scales[:, :2] == 0).all() and torch.isfinite(enc.scales).all()
    out = tcompress.decode(enc).numpy()
    np.testing.assert_array_equal(out, jref.decode_codec_ref(words, scales, x.shape, level))
    assert np.isfinite(out).all() and (out[:, :256] == 0).all()


def test_codec_sizes_and_level0():
    for raw in (65536, 24576):
        assert [tcompress.scaled_payload_nbytes(raw, lvl) for lvl in (0, 1, 2)] == \
            [jcompress.scaled_payload_nbytes(raw, lvl) for lvl in (0, 1, 2)]
    for n in (1, 127, 128, 700, 16384):
        for lvl in tcompress.LEVELS:
            assert tcompress.compressed_nbytes(n, lvl) == jcompress.compressed_nbytes(n, lvl)
    x = torch.as_tensor(_rand((4, 320), seed=5))
    assert tref.roundtrip_codec_ref(x, 0) is x
    assert tcompress.roundtrip(x, 0) is x
    with pytest.raises(ValueError):
        tcompress.encode(x, 0)
    with pytest.raises(ValueError):  # a permuted view would regroup every scale
        tcompress.encode(torch.zeros(2, 4, 4, 8).permute(0, 3, 1, 2), 1)
