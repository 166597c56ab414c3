"""Rounding of a product's operands to a lower precision, for the control.

The plain references compute in float32. Their control, the reference put
in the program's place one precision below what the configuration states,
rounds every operand of every product (convolution, projection, attention)
through `round_to` first and then computes in float32: TF32 keeps 10
mantissa bits (what the card's TF32 tensor cores read), fp8 is e4m3 with
one scale per tensor (absmax to 448). The same on the CPU and the card.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32", "fp8")


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` (float32) rounded to `precision` and held in float32."""
    if precision == "float32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
