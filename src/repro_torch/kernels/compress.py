"""K3 / K4: the bottleneck codec for the offload payload (CUDA,
`csrc/codec.cu`): encode on the edge, decode in the cloud.

Per (row, 128-feature group) of the flattened activation: an absmax
scale, then signed int8 (level 1) or int4 (level 2) values packed
little-endian into uint32 words, with the float32 scales written in the
same pass. Port of `repro.kernels.compress`; the wire format is
bit-exact with `ref.encode_codec_ref`, and the compressed size is
analytic (`compressed_nbytes`), so pricing never touches a tensor.

The payload must be contiguous in its own layout: the codec groups 128
consecutive features per sample, so for B-AlexNet an NHWC activation.
`encode` raises on a non-contiguous input rather than copying a permuted
view (which would regroup every scale).

On the card, `encode_layout` picks K3's layout and grid from the payload's
shape and alignment (a pure function, so the CPU tests check the choice):
`narrow` for rows of at most 32 features, several rows a warp; `quad`, a
warp per (row, group), for payloads of up to `QUAD_PAIRS` groups; else
`wide`, a half-warp per (row, group); `_scalar` where a row start is not
16-byte aligned.

Dispatch: `encode` and `decode` call the ops ``repro_torch::encode``
and ``repro_torch::decode`` on the (rows, features) layout. The dispatcher
sends CPU tensors to `ref.encode_codec_ref` / `decode_codec_ref`, CUDA
tensors to the kernels (`encode_kernel` / `decode_kernel`, which refuse
anything else) or the call raises, and fake or meta tensors to the ops'
fake implementations, which read no data.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch._device import as_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    CODEC_BITS,
    CODEC_TILE,
    _codec_layout,
    decode_codec_ref,
    encode_codec_ref,
)

#: the codec's public level axis: 0 = identity float32, 1 = int8, 2 = int4
LEVELS = (0, 1, 2)

ENCODE = _build.Kernel(
    "encode",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int],
)
DECODE = _build.Kernel(
    "decode",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def compressed_nbytes(n_elements: int, level: int) -> int:
    """Wire bytes for an n-element float32 payload at `level` (analytic,
    unpadded): packed values + one float32 scale per 128-element group."""
    n = int(n_elements)
    if int(level) == 0:
        return 4 * n
    bits = CODEC_BITS[int(level)]
    groups = -(-n // CODEC_TILE)
    return (n * bits + 7) // 8 + 4 * groups


def scaled_payload_nbytes(raw_nbytes: int, level: int) -> int:
    """Wire bytes for a payload whose RAW float32 size is `raw_nbytes`.
    Level 0 returns `raw_nbytes` unchanged."""
    if int(level) == 0:
        return int(raw_nbytes)
    return compressed_nbytes(int(raw_nbytes) // 4, level)


def _groups(cols: int) -> int:
    return -(-cols // CODEC_TILE)


_LEVEL_OF_BITS = {bits: level for level, bits in CODEC_BITS.items()}

#: K3's layouts, numbered as `csrc/codec.cu` numbers them
ENCODE_LAYOUTS = ("wide", "wide_scalar", "quad", "quad_scalar", "narrow")
#: rows of at most this many features take the narrow layout
NARROW_COLS = 32
NARROW_ROWS_PER_WARP = 4
#: payloads of at most this many (row, group) pairs take the quad layout: on
#: the H100 it led the wide one up to 16 384 pairs and tied it at 24 576 and
#: 32 256; wide led by 2-4% at 65 536 (`tools/codec_ab.py --layouts`, PERF.md)
QUAD_PAIRS = 32768
THREADS = 128
MAX_BLOCKS = 65535


@dataclass(frozen=True)
class EncodeLayout:
    """How K3 is launched: `kind` one of `ENCODE_LAYOUTS`, on a grid of
    `blocks` blocks of `threads` threads."""

    kind: str
    threads: int
    blocks: int


def encode_layout(rows: int, cols: int, aligned: bool) -> EncodeLayout:
    """K3's layout and grid for a (rows, cols) payload, at either width,
    whose base pointer is 16-byte aligned if `aligned`.

    narrow (cols <= 32): a row is one partial group on 8 lanes, 4 rows a
    warp. Otherwise a (row, group) pair is a warp's (quad, 4 values a
    lane) for at most `QUAD_PAIRS` pairs, else a half-warp's (wide, two
    pairs a warp, 8 values a lane); the `_scalar` kinds load a value at a
    time where a row start is not 16-byte aligned. A warp for each step,
    in blocks of `THREADS` threads, up to `MAX_BLOCKS` blocks (past that the
    warps loop)."""
    if cols <= NARROW_COLS:
        kind, warps = "narrow", -(-rows // NARROW_ROWS_PER_WARP)
    else:
        pairs = rows * _groups(cols)
        kind, warps = ("quad", pairs) if pairs <= QUAD_PAIRS else ("wide", -(-pairs // 2))
        if not (aligned and cols % 4 == 0):
            kind += "_scalar"
    return EncodeLayout(kind, THREADS, min(-(-warps * 32 // THREADS), MAX_BLOCKS))


# ---------------------------------------------------------------- kernels
def encode_kernel(z: torch.Tensor, bits: int):
    """z: (rows, cols) contiguous float32 on the card. Returns (words
    uint32 (rows, ceil(cols/128)*128*bits/32), scales float32 (rows,
    ceil(cols/128)))."""
    _build.check_cuda_tensor(z, "payload", (torch.float32,), 2)
    rows, cols = z.shape
    if rows >= 2**31 or cols >= 2**31:
        raise ValueError(f"encode takes dims < 2^31, got {tuple(z.shape)}")
    if bits not in _LEVEL_OF_BITS:
        raise ValueError(f"encode takes 8 or 4 bits, got {bits}")
    g = _groups(cols)
    if rows * g >= 2**31:
        raise ValueError(f"encode takes fewer than 2^31 (row, group) pairs, got {rows * g}")
    words = torch.empty((rows, g * CODEC_TILE * bits // 32), dtype=torch.uint32, device=z.device)
    scales = torch.empty((rows, g), dtype=torch.float32, device=z.device)
    lay = encode_layout(rows, cols, z.data_ptr() % 16 == 0)
    ENCODE(z.device, z.data_ptr(), rows, cols, bits, words.data_ptr(), scales.data_ptr(),
           ENCODE_LAYOUTS.index(lay.kind), lay.threads, lay.blocks)
    return words, scales


def decode_kernel(words: torch.Tensor, scales: torch.Tensor, cols: int, bits: int):
    """Inverse of `encode_kernel`: (rows, cols) float32 on the card."""
    _build.check_cuda_tensor(words, "words", (torch.uint32,), 2)
    _build.check_cuda_tensor(scales, "scales", (torch.float32,), 2)
    rows = words.shape[0]
    g = _groups(cols)
    if tuple(words.shape) != (rows, g * CODEC_TILE * bits // 32) or tuple(scales.shape) != (rows, g):
        raise ValueError(
            f"words {tuple(words.shape)} / scales {tuple(scales.shape)} do not hold "
            f"{cols} features at {bits} bits"
        )
    out = torch.empty((rows, cols), dtype=torch.float32, device=words.device)
    DECODE(words.device, words.data_ptr(), scales.data_ptr(), rows, cols, bits, out.data_ptr())
    return out


# ---------------------------------------------------------------- the ops
def _encode_cpu(z, bits):
    return encode_codec_ref(z, _LEVEL_OF_BITS[bits])


def _encode_fake(z, bits):
    rows, cols = z.shape
    g = _groups(cols)
    return (z.new_empty((rows, g * CODEC_TILE * bits // 32), dtype=torch.uint32),
            z.new_empty((rows, g), dtype=torch.float32))


def _decode_cpu(words, scales, cols, bits):
    return decode_codec_ref(words, scales, (words.shape[0], cols), _LEVEL_OF_BITS[bits])


def _decode_fake(words, scales, cols, bits):
    return words.new_empty((words.shape[0], cols), dtype=torch.float32)


_build.define_op("encode(Tensor z, int bits) -> (Tensor, Tensor)", encode_kernel, _encode_cpu,
                 _encode_fake)
_build.define_op("decode(Tensor words, Tensor scales, int cols, int bits) -> Tensor",
                 decode_kernel, _decode_cpu, _decode_fake)


# ----------------------------------------------------------- public wrappers
@dataclass(frozen=True)
class EncodedPayload:
    """One encoded offload payload: the wire image + enough metadata to
    decode. `nbytes` is the analytic unpadded wire size (what the uplink
    is charged), not the padded device buffer size."""

    words: torch.Tensor  # (rows, ceil(features/128)*128 * bits / 32) uint32
    scales: torch.Tensor  # (rows, ceil(features/128)) float32
    shape: Tuple[int, ...]
    level: int

    @property
    def nbytes(self) -> int:
        rows, cols = _codec_layout(self.shape)
        return rows * compressed_nbytes(cols, self.level)


def encode(x, level: int, device=None) -> EncodedPayload:
    """Encode an arbitrary-shape float payload (contiguous; numpy lands on
    `device`). The CPU path is the oracle; on the card, the K3 kernel."""
    level = int(level)
    if level == 0:
        raise ValueError("level 0 is the identity; nothing to encode")
    x = as_tensor(x, device)
    if not x.is_contiguous():
        raise ValueError("the codec groups consecutive features: pass a contiguous payload")
    shape = tuple(int(d) for d in x.shape)
    rows, cols = _codec_layout(shape)
    words, scales = torch.ops.repro_torch.encode.default(x.reshape(rows, cols).to(torch.float32),
                                                         CODEC_BITS[level])
    return EncodedPayload(words=words, scales=scales, shape=shape, level=level)


def decode(enc: EncodedPayload) -> torch.Tensor:
    """Decode an `EncodedPayload` back to float32 in its original shape."""
    _, cols = _codec_layout(enc.shape)
    return torch.ops.repro_torch.decode.default(enc.words, enc.scales, cols,
                                                CODEC_BITS[int(enc.level)]).reshape(enc.shape)


def roundtrip(x, level: int, device=None):
    """decode(encode(x)); level 0 is the identity."""
    if int(level) == 0:
        return as_tensor(x, device)
    return decode(encode(x, level, device=device))
