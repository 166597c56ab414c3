"""Synthetic datasets, generated locally with no downloads.

A copy of `repro.data.synthetic` (numpy only), so the port never imports
`repro`; the same seed gives the same arrays in both packages.

Two generators, both fully seeded/deterministic:

1. `cifar_like`: a 10-class 32x32x3 image task standing in for CIFAR-10
   with the paper's 45k/3k/7k split. Class templates are smooth random
   fields; each sample = template + per-sample deformation + noise whose
   magnitude is drawn from an easy/hard mixture. The mixture is what gives
   early exits their operating regime: easy samples are separable from
   shallow features (the paper's premise that "a large portion of the
   input samples" can exit early).

2. `lm_sequences`: token streams for the language-model end-to-end runs.
   A hidden 2nd-order Markov teacher over the vocab generates structure a
   ~100M model can learn in a few hundred steps (loss drops well below the
   uniform-entropy floor), mixed with span-copy segments that reward
   attention/state-tracking.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ImageSplits:
    train_x: np.ndarray
    train_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray


def _smooth_field(rng, shape, smooth=4):
    f = rng.standard_normal(shape).astype(np.float32)
    # cheap separable box blur for spatial smoothness
    for axis in (0, 1):
        for _ in range(smooth):
            f = 0.5 * f + 0.25 * (np.roll(f, 1, axis) + np.roll(f, -1, axis))
    return f


def cifar_like(
    n_train: int = 45_000,
    n_val: int = 3_000,
    n_test: int = 7_000,
    n_classes: int = 10,
    easy_frac: float = 0.6,
    noise: float = 1.2,
    seed: int = 0,
) -> ImageSplits:
    """Paper split: 45,000 / 3,000 / 7,000 (Sec. III).

    Easy samples: the class template + noise (learnable to ~high accuracy).
    Hard samples: a convex MIX of two class templates with mixing weight
    alpha in [0.5, 0.85], and the LABEL DRAWN FROM THE MIXTURE (y_a with
    prob alpha, y_b otherwise). That is irreducible aleatoric uncertainty:
    the Bayes-optimal accuracy on hard samples is E[max(alpha, 1-alpha)]
    ~ 0.68, so overall Bayes accuracy ~ easy_frac + (1-easy_frac)*0.68 --
    the ~80% regime of the paper's CIFAR-10 B-AlexNet. A conventionally
    trained network fits one-hot labels on ambiguous inputs and becomes
    overconfident at test time -- exactly the miscalibration the paper
    studies; a calibrated exit should report confidence ~ alpha.
    """
    rng = np.random.default_rng(seed)
    templates = np.stack(
        [_smooth_field(rng, (32, 32, 3)) for _ in range(n_classes)]
    )  # (C,32,32,3)
    templates /= np.sqrt(np.mean(templates**2, axis=(1, 2, 3), keepdims=True))

    def make(n, rng):
        ya = rng.integers(0, n_classes, size=n).astype(np.int32)
        easy = rng.random(n) < easy_frac
        yb = (ya + rng.integers(1, n_classes, size=n)).astype(np.int32) % n_classes
        alpha = np.where(easy, 1.0, rng.uniform(0.5, 0.85, size=n)).astype(np.float32)
        base = (
            alpha[:, None, None, None] * templates[ya]
            + (1.0 - alpha[:, None, None, None]) * templates[yb]
        )
        x = base + noise * rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
        # label drawn from the mixture (aleatoric)
        take_a = rng.random(n) < alpha
        y = np.where(take_a, ya, yb).astype(np.int32)
        return x.astype(np.float32), y

    tx, ty = make(n_train, rng)
    vx, vy = make(n_val, rng)
    sx, sy = make(n_test, rng)
    return ImageSplits(tx, ty, vx, vy, sx, sy)


def lm_sequences(
    n_tokens: int,
    vocab_size: int,
    seed: int = 0,
    order: int = 2,
    branch: int = 8,
    copy_prob: float = 0.15,
    copy_span: int = 16,
) -> np.ndarray:
    """Deterministic token stream with learnable structure.

    Markov teacher: each (t-2, t-1) context admits only `branch` successors
    (hashed), giving a ceiling of log(branch) nats instead of log(V). Span
    copy: with prob copy_prob a recent span is replayed verbatim.
    """
    rng = np.random.default_rng(seed)
    out = np.empty(n_tokens, np.int64)
    out[:order] = rng.integers(0, vocab_size, order)
    i = order
    while i < n_tokens:
        if i > copy_span * 2 and rng.random() < copy_prob:
            start = rng.integers(max(0, i - 512), i - copy_span)
            span = min(copy_span, n_tokens - i)
            out[i : i + span] = out[start : start + span]
            i += span
            continue
        if order == 1:
            c = (out[i - 1] * 10_007) % (2**31)
        else:
            c = (out[i - 2] * 1_000_003 + out[i - 1] * 10_007) % (2**31)
        successors = (c + np.arange(branch) * 97_911) % vocab_size
        out[i] = successors[rng.integers(0, branch)]
        i += 1
    return out.astype(np.int32)
