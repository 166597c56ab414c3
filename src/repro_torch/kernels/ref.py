"""Plain PyTorch versions of every kernel in this package.

Each function here is the CPU path of its kernel wrapper and the oracle
the hand-written CUDA kernel is held against on the card. They run on any
device; the arithmetic follows `repro.kernels.ref` step for step (float32
throughout, the codec bit-exact).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _temperature(temperature, device) -> torch.Tensor:
    return torch.as_tensor(temperature, dtype=torch.float32, device=device)


def exit_gate_ref(logits, temperature):
    """(confidence, entropy, argmax) of softmax(logits / T), row-wise.

    logits: (..., vocab). Float32 math throughout; argmax is int32 and
    keeps the first index on ties.
    """
    z = logits.to(torch.float32) / _temperature(temperature, logits.device)
    m = torch.amax(z, dim=-1, keepdim=True)
    logp = z - m - torch.log(torch.sum(torch.exp(z - m), dim=-1, keepdim=True))
    p = torch.exp(logp)
    conf = torch.amax(p, dim=-1)
    ent = -torch.sum(p * logp, dim=-1)
    idx = torch.argmax(z, dim=-1).to(torch.int32)
    return conf, ent, idx


def calib_nll_ref(logits, labels, temperature):
    """(E_p[z], E_p[z^2], z_y, nll) per row; p = softmax(z/T)."""
    z = logits.to(torch.float32)
    t = _temperature(temperature, z.device)
    u = z / t
    m = torch.amax(u, dim=-1, keepdim=True)
    e = torch.exp(u - m)
    s = torch.sum(e, dim=-1)
    p = e / s[..., None]
    e1 = torch.sum(p * z, dim=-1)
    e2 = torch.sum(p * z * z, dim=-1)
    zy = torch.gather(z, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = torch.log(s) + m[..., 0] - zy / t
    return e1, e2, zy, nll


# ------------------------------------------------- bottleneck codec oracle
#: elements per scale group -- one float32 scale per TILE consecutive
#: features of a sample's flattened payload
CODEC_TILE = 128
#: level -> integer bits per quantized value (level 0 is identity and
#: never reaches the codec)
CODEC_BITS = {1: 8, 2: 4}


def _codec_layout(shape):
    """Canonical 2D view: one row per leading-axis sample, features
    flattened into columns (the per-sample vector the groups run over)."""
    if len(shape) <= 1:
        return 1, int(shape[0]) if shape else 1
    rows = int(shape[0])
    cols = 1
    for d in shape[1:]:
        cols *= int(d)
    return rows, cols


def _qmax(bits: int):
    """(qmax, f32(1/qmax)) as Python floats holding float32 values exactly."""
    qmax = np.float32((1 << (bits - 1)) - 1)
    return float(qmax), float(np.float32(1.0) / qmax)


def encode_codec_ref(x, level: int):
    """Absmax per-group quantize + pack: the bit-exact oracle for the
    encode kernel.

    x: any-shape float tensor, canonicalized to (rows, features). Per
    (row, 128-feature group): scale = absmax * f32(1/qmax), values
    rounded half-to-even to `CODEC_BITS[level]`-bit signed ints packed
    little-endian into uint32 words. Non-finite inputs are zeroed before
    the absmax; an all-zero group stores scale 0 and divides by 1.
    Packing runs in int64 (torch has no uint32 shifts on the CPU) and
    keeps the same bits.

    Returns (words, scales): words (rows, padded_features * bits / 32)
    uint32, scales (rows, padded_features / 128) float32.
    """
    bits = CODEC_BITS[int(level)]
    per = 32 // bits
    qmax, inv_qmax = _qmax(bits)
    rows, cols = _codec_layout(x.shape)
    z = x.reshape(rows, cols).to(torch.float32)
    pad = (-cols) % CODEC_TILE
    if pad:
        z = F.pad(z, (0, pad))
    z = torch.where(torch.isfinite(z), z, torch.zeros((), dtype=z.dtype, device=z.device))
    g = z.shape[1] // CODEC_TILE
    zt = z.reshape(rows, g, CODEC_TILE)
    scales = torch.amax(torch.abs(zt), dim=2) * inv_qmax
    safe = torch.where(scales > 0, scales, torch.ones((), dtype=scales.dtype, device=z.device))
    q = torch.clamp(torch.round(zt / safe[:, :, None]), -qmax, qmax).to(torch.int64)
    qf = q.reshape(rows, g * CODEC_TILE)
    mask = (1 << bits) - 1
    words = torch.zeros((rows, qf.shape[1] // per), dtype=torch.int64, device=z.device)
    for k in range(per):
        words |= (qf[:, k::per] & mask) << (bits * k)
    # int64 -> int32 keeps the low 32 bits; the view reinterprets them
    return words.to(torch.int32).view(torch.uint32), scales


def decode_codec_ref(words, scales, shape, level: int):
    """Inverse of `encode_codec_ref`: unpack, sign-extend, rescale.
    Returns float32 in the original `shape`."""
    bits = CODEC_BITS[int(level)]
    per = 32 // bits
    half, full = 1 << (bits - 1), 1 << bits
    w = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rows, nw = w.shape
    v = torch.empty((rows, nw, per), dtype=torch.int64, device=w.device)
    for k in range(per):
        u = (w >> (bits * k)) & (full - 1)
        v[:, :, k] = torch.where(u >= half, u - full, u)
    zt = v.reshape(rows, -1, CODEC_TILE).to(torch.float32) * scales[:, :, None]
    _, cols = _codec_layout(shape)
    return zt.reshape(rows, -1)[:, :cols].reshape(shape)


def roundtrip_codec_ref(x, level: int):
    """decode(encode(x)) -- what the cloud sees after a compressed
    offload. Level 0 is the identity (the input object, no cast)."""
    if int(level) == 0:
        return x
    words, scales = encode_codec_ref(x, level)
    return decode_codec_ref(words, scales, tuple(x.shape), level)


#: absmax magnitudes of `codec_tie_payload`'s groups; the last gives a
#: subnormal int8 scale (1e-37 / 127)
_TIE_ABSMAX = (1.0, 3.7, 0.0123, 250.0, 6.1e4, 1e-37)


def _tie_values(absmax: np.float32, bits: int) -> np.ndarray:
    """Every z with fl(z / scale) == k + 0.5 exactly (k = 0 .. qmax - 1;
    scale = absmax * f32(1/qmax), rounded as the codec rounds it) that
    lies within 4 ulps of (k + 0.5) * scale, each beside its float32
    neighbours on either side."""
    qmax, inv = _qmax(bits)
    s = np.float32(absmax * np.float32(inv))
    out = []
    for k in range(int(qmax)):
        h = np.float32(k + 0.5)
        z0 = np.float32(h * s).view(np.uint32).astype(np.int64)
        zs = (z0 + np.arange(-4, 5)).astype(np.uint32).view(np.float32)
        for z in zs[zs / s == h]:
            out += [np.nextafter(z, np.float32(0)), z, np.nextafter(z, np.float32(np.inf))]
    return np.asarray(out, np.float32)


def codec_tie_payload(rows: int, cols: int, bits: int, seed: int = 0,
                      absmax=_TIE_ABSMAX) -> np.ndarray:
    """A (rows, cols) float32 payload of the codec's rounding ties: in each
    (row, 128-feature group) one value is +-absmax, at a random place, and
    the rest are values whose quotient by the group's scale is exactly
    k + 0.5 after the divide's rounding, and their float32 neighbours,
    with random signs. A divide that is off by one ulp changes codes here;
    on standard normals it almost never does. The groups' absmax cycles
    through `absmax`; each group repeats its list from a random offset. Row
    0's first group holds its absmax and zeros, row 1's only +-absmax."""
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, cols), np.float32)
    ties = {a: _tie_values(np.float32(a), bits) for a in absmax}
    n = 0
    for r in range(rows):
        for c0 in range(0, cols, CODEC_TILE):
            w = min(CODEC_TILE, cols - c0)
            a = absmax[n % len(absmax)]
            n += 1
            t = ties[a]
            vals = np.resize(np.roll(t, -int(rng.integers(len(t)))), w)
            vals *= rng.choice(np.float32([-1, 1]), w)
            if c0 == 0 and r < 2:
                vals[:] = 0 if r == 0 else np.float32(a) * rng.choice([-1, 1], w)
            vals[rng.integers(w)] = np.float32(a) * rng.choice([-1, 1])
            x[r, c0:c0 + w] = vals
    return x
