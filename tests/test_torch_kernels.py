"""Port parity for the four kernels: the plain PyTorch versions in
`repro_torch.kernels` (the CPU path of every kernel wrapper) against the
reference's Pallas kernels in interpret mode and its oracles.

The same numpy inputs, made from a seed, go through both packages.
Tolerances: K1 conf rtol 2e-5 / atol 1e-6, entropy rtol 2e-5 / atol
2e-5, argmax exact (as `test_kernels.py`); K2 NLL rtol 1e-5 / atol 1e-6,
dNLL/dT rtol 5e-3 / atol 1e-5, d2NLL/dT2 rtol 5e-3 / atol 1e-3, the
kernel Newton fit within 0.05; the codec bit-exact on words, scales and
decoded floats. K5 (qk-norm and RoPE) has no Pallas kernel: its plain
version is held bit for bit to the port's chain as it stood before K5.
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
from repro_torch.kernels import qk_rope as tqk_rope
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers


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
                                    tcompress.DECODE, tqk_rope.KERNEL], ids=lambda k: k.name)
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


# --------------------------------------------- K3: division ties, layouts
#: the absmax values whose scale stays a normal float32: XLA on the CPU
#: flushes subnormals, so the Pallas encode is held to the oracle on these
_NORMAL_TIE_ABSMAX = tuple(a for a in tref._TIE_ABSMAX if a * (1 / 127) > 1.2e-38)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("shape", [(6, 384), (5, 301), (12, 10)])
def test_codec_division_ties_bitexact(level, shape):
    """Quotients z / scale exactly on k + 0.5 after the divide's rounding,
    their float32 neighbours, a group of absmax and zeros, a group of
    +-absmax and a subnormal scale: the plain version against the
    reference's oracle bit for bit, and against its Pallas encode on the
    groups whose scale is normal."""
    bits = tref.CODEC_BITS[level]
    x = tref.codec_tie_payload(*shape, bits, seed=shape[0] + level)
    enc = tcompress.encode(torch.as_tensor(x), level)
    words, scales = jref.encode_codec_ref(x, level)
    np.testing.assert_array_equal(_u32(enc.words), words)
    np.testing.assert_array_equal(enc.scales.numpy().view(np.uint32), scales.view(np.uint32))
    out = tcompress.decode(enc).numpy()
    want = jref.decode_codec_ref(words, scales, x.shape, level)
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))
    # the payload does hold exact ties: some fl(z / scale) is k + 0.5
    zt = np.pad(x, ((0, 0), (0, (-shape[1]) % 128))).reshape(shape[0], -1, 128)
    safe = np.where(scales > 0, scales, np.float32(1))[:, :, None]
    q = zt / safe
    assert ((q - np.floor(q)) == 0.5).sum() >= 4
    xn = tref.codec_tie_payload(*shape, bits, seed=shape[0] + level, absmax=_NORMAL_TIE_ABSMAX)
    jenc = jcompress.encode(xn, level)
    enc = tcompress.encode(torch.as_tensor(xn), level)
    np.testing.assert_array_equal(_u32(enc.words), np.asarray(jenc.words))
    np.testing.assert_array_equal(enc.scales.numpy(), np.asarray(jenc.scales))


def _kernel_codes(x, bits, fix_up=True):
    """codec.cu's `pack_codes` in numpy float32, one rounding an operation:
    t = z * f32(1/safe) rounded half-to-even through 1.5 * 2^23; a value
    with t within 2^-14 of a half-integer, or a subnormal safe, takes the
    IEEE quotient instead (`fix_up=False` leaves the fast path alone).
    Returns the clamped codes (rows, groups, 128)."""
    qmax, inv = tref._qmax(bits)
    rows, cols = x.shape
    z = np.pad(x, ((0, 0), (0, (-cols) % 128))).reshape(rows, -1, 128)
    z = np.where(np.isfinite(z), z, np.float32(0))
    scale = np.abs(z).max(-1) * np.float32(inv)
    safe = np.where(scale > 0, scale, np.float32(1))[:, :, None]
    magic = np.float32(12582912.0)
    with np.errstate(over="ignore", invalid="ignore"):
        t = z * (np.float32(1) / safe)
        m = t + magic
        near = np.abs(t - (m - magic)) >= np.float32(0.5 - 2.0**-14)
        fast = m.view(np.int32).astype(np.int64) - 0x4B400000
    q = fast
    if fix_up:
        slow = near | (safe < np.finfo(np.float32).tiny)
        q = np.where(slow, np.rint(z / safe), fast)
    return np.clip(q, -qmax, qmax)


@pytest.mark.parametrize("level", [1, 2])
def test_codec_kernel_quantizer_is_the_ieee_divide(level):
    """The kernel's reciprocal multiply with its near-tie fix-up gives the
    IEEE divide's codes on the tie payload (subnormal scale included) and
    on normals over 78 decades of magnitude; without the fix-up the tie
    payload changes codes, so these cases would catch a divide that is off
    by one ulp."""
    bits = tref.CODEC_BITS[level]
    qmax, _ = tref._qmax(bits)
    rng = np.random.default_rng(level)
    wide = (rng.standard_normal((64, 10, 128))
            * np.exp(rng.uniform(-95, 85, (64, 10, 1)))).astype(np.float32).reshape(64, 1280)
    for x in (tref.codec_tie_payload(24, 640, bits, seed=level), wide, _rand((300, 384), seed=9)):
        words, scales = jref.encode_codec_ref(x, level)
        zt = np.pad(x, ((0, 0), (0, (-x.shape[1]) % 128))).reshape(x.shape[0], -1, 128)
        zt = np.where(np.isfinite(zt), zt, np.float32(0))
        safe = np.where(scales > 0, scales, np.float32(1))[:, :, None]
        want = np.clip(np.rint(zt / safe), -qmax, qmax)
        np.testing.assert_array_equal(_kernel_codes(x, bits), want)
    ties = tref.codec_tie_payload(24, 640, bits, seed=level)
    words, scales = jref.encode_codec_ref(ties, level)
    zt = ties.reshape(24, -1, 128)
    safe = np.where(scales > 0, scales, np.float32(1))[:, :, None]
    assert (_kernel_codes(ties, bits, fix_up=False) != np.clip(np.rint(zt / safe), -qmax, qmax)).any()


def _encode_walk(lay, rows, cols):
    """The (row, group) pairs K3's grid encodes, as `codec.cu` walks them,
    as flat indices row * groups + group. wide: warp w of the grid's W takes
    steps s = w, w + W, ..., pairs 2s and 2s + 1. quad: warp w takes pairs
    w, w + W, .... narrow: warp w takes rows w * R .. w * R + R - 1 (R =
    `NARROW_ROWS_PER_WARP`), then W * R on."""
    nwarps = lay.blocks * lay.threads // 32
    if lay.kind.startswith("quad"):  # warp w: pairs w, w + W, ...
        got = np.add.outer(np.arange(0, rows * -(-cols // 128), nwarps), np.arange(nwarps)).ravel()
        return got[got < rows * -(-cols // 128)]
    if lay.kind == "narrow":
        per = tcompress.NARROW_ROWS_PER_WARP
        # warp w's bases w * per + i * nwarps * per, for every i the loop runs
        bases = np.add.outer(np.arange(0, rows, nwarps * per), np.arange(nwarps) * per).ravel()
        got = np.add.outer(bases[bases < rows], np.arange(per)).ravel()
        return got[got < rows]
    pairs = rows * -(-cols // 128)
    steps = -(-pairs // 2)
    s = np.add.outer(np.arange(0, steps, nwarps), np.arange(nwarps)).ravel()
    got = np.add.outer(2 * s[s < steps], np.arange(2)).ravel()
    return got[got < pairs]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows,cols", [(1, 10), (3000, 10), (5, 301), (3, 700), (1, 16384),
                                       (512, 16384), (4, 786_432),
                                       # either side of QUAD_PAIRS = 256 * 128
                                       (256, 16384), (257, 16384),
                                       # more work than MAX_BLOCKS blocks: the warps loop
                                       (3_000_000, 10), (4096, 65536)])
def test_encode_layout_covers_every_pair_once(rows, cols, aligned):
    """The layout K3 takes for a payload (the same at int8 and int4), and
    its grid encodes every (row, group) exactly once; a one-request payload
    spreads over more blocks than a block of 8 warps a group would give it."""
    lay = tcompress.encode_layout(rows, cols, aligned)
    groups = -(-cols // 128)
    if cols <= 32:
        want = "narrow"
    else:
        want = "quad" if rows * groups <= tcompress.QUAD_PAIRS else "wide"
        want += "" if aligned and cols % 4 == 0 else "_scalar"
    assert lay.kind == want
    assert lay.kind in tcompress.ENCODE_LAYOUTS
    assert lay.threads % 32 == 0 and 32 <= lay.threads <= 256  # codec.cu's kMaxEncodeThreads
    assert 1 <= lay.blocks <= tcompress.MAX_BLOCKS
    counts = np.bincount(_encode_walk(lay, rows, cols), minlength=rows * groups)
    assert counts.shape == (rows * groups,) and (counts == 1).all()
    if rows == 1 and cols > 32:
        assert lay.blocks > -(-groups // 8)


# ------------------------------------------------------------------- K5
def _chain_before_k5(q, k, q_scale, k_scale, positions, theta):
    """qk-norm and RoPE as `_project_qkv` ran them before K5, theta copied
    from the host into a tensor as `rope_freqs` then made it."""
    hd = q.shape[-1]
    if q_scale is not None:
        q, k = tlayers.rms_norm_headwise(q, q_scale), tlayers.rms_norm_headwise(k, k_scale)
    exps = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    return tlayers.apply_rope(q, cos, sin), tlayers.apply_rope(k, cos, sin)


def _positions(kind, b, s):
    if kind == "expanded":  # the partitions' arange, batch stride 0
        return torch.arange(s, dtype=torch.int32).expand(b, s)
    if kind == "contiguous":
        return (7 + 3 * torch.arange(b * s, dtype=torch.int64)).reshape(b, s)
    return torch.full((b, 1), 511, dtype=torch.int32)  # a decode step


@pytest.mark.parametrize("heads", [(32, 8, 128), (8, 2, 128), (2, 8, 64)],
                         ids=["one-device", "model-4", "model-16-kv-whole"])
@pytest.mark.parametrize("positions", ["expanded", "contiguous", "decode"])
@pytest.mark.parametrize("norm", [True, False], ids=["qk-norm", "rope-only"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_qk_norm_rope_plain_equals_chain_before_k5(heads, positions, norm, dtype):
    """The op's CPU implementation is the plain chain of `_project_qkv`, bit
    for bit, at a model axis's local head counts too (q heads split, kv
    heads split or whole)."""
    qh, kvh, hd = heads
    g = torch.Generator().manual_seed(qh * 31 + hd)
    pos = _positions(positions, 2, 5)
    b, s = pos.shape
    q = (2 * torch.randn(b, s, qh, hd, generator=g)).to(dtype)
    k = (2 * torch.randn(b, s, kvh, hd, generator=g)).to(dtype)
    scales = (1 + 0.1 * torch.randn(hd, generator=g), 1 + 0.1 * torch.randn(hd, generator=g))
    scales = scales if norm else (None, None)
    got = tqk_rope.qk_norm_rope(q, k, *scales, pos, 1e6)
    want = _chain_before_k5(q, k, *scales, pos, 1e6)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, w)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("hd", [64, 128, 80])
def test_rope_tables_equal_theta_copied_from_the_host(theta, hd):
    """`rope_tables` makes theta on the positions' device and gives the
    tables of a theta copied from the host, bit for bit."""
    pos = torch.stack([torch.arange(0, 4096, 64), torch.arange(7, 4103, 64)]).to(torch.int32)
    exps = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    ang = pos.to(torch.float32)[..., None] * (1.0 / torch.pow(torch.tensor(
        theta, dtype=torch.float32), exps))
    cos, sin = tlayers.rope_tables(pos, hd, theta)
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin, torch.sin(ang))


def test_qk_norm_rope_fake_and_takes():
    """On fake ``cuda`` tensors K5's op gives outputs of the inputs' shapes
    and dtype, and `takes` accepts what the partitions pass; it refuses the
    CPU, float16, a head_dim outside `HEAD_DIMS`, positions of another
    shape and q and k of two dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cpu = torch.zeros(2, 3, 4, 128, dtype=torch.bfloat16)
    assert not tqk_rope.takes(cpu, cpu, torch.zeros(2, 3, dtype=torch.int32))
    with FakeTensorMode():
        def t(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device="cuda")

        q, k, pos = t(2, 3, 32, 128), t(2, 3, 8, 128), t(2, 3, dtype=torch.int32)
        assert tqk_rope.takes(q, k, pos)
        assert tqk_rope.takes(t(2, 3, 24, 64, dtype=torch.float32),
                              t(2, 3, 8, 64, dtype=torch.float32), t(2, 3, dtype=torch.int64))
        assert not tqk_rope.takes(t(2, 3, 4, 128, dtype=torch.float16),
                                  t(2, 3, 4, 128, dtype=torch.float16), pos)
        assert not tqk_rope.takes(t(2, 3, 4, 48), t(2, 3, 4, 48), pos)
        assert not tqk_rope.takes(q, k, t(1, 3, dtype=torch.int32))
        assert not tqk_rope.takes(q, k.float(), pos)
        for scales in ((None, None), (t(128, dtype=torch.float32), t(128, dtype=torch.float32))):
            oq, ok = tqk_rope.qk_norm_rope(q, k, *scales, pos, 1e6)
            assert (oq.shape, oq.dtype, oq.device.type) == (q.shape, q.dtype, "cuda")
            assert (ok.shape, ok.dtype, ok.device.type) == (k.shape, k.dtype, "cuda")
