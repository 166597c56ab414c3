"""Seeded, parametric input distortions (the drifting-input workload axis).

Pacheco et al. ("Early-exit DNNs for distorted images", 2108.09343) show
that one calibrator fit on clean validation data breaks when inputs arrive
blurred or noisy, and that per-distortion *expert* calibrators restore
reliable offloading. This module supplies the distortion side of that
experiment for the synthetic `cifar_like` task:

* a taxonomy of parametric distortions -- `gaussian_noise`, `gaussian_blur`,
  `box_blur`, `contrast`, `brightness` -- each at severity levels 1..5
  (severity 0 / kind ``clean`` is the identity);
* `apply_distortion`, fully seeded and deterministic, plus `distort_splits`
  to distort whole `ImageSplits`;
* `input_features`: the cheap per-image statistics (Laplacian variance,
  pixel moments, total variation) a
  `repro_torch.core.bank.DistortionEstimator` uses on the edge device to
  recognize the current distortion context -- no extra DNN, just a handful
  of numpy reductions per image.

Parameters are scale-free where the distortion is relative to image
statistics (noise/brightness in units of per-image std, contrast around the
per-image mean), and in pixels where it is geometric (blur widths), so the
same severity tables apply to any roughly-stationary image distribution.
Blurs use periodic (roll-based) boundaries, matching how `cifar_like`
synthesizes its smooth class templates.

Port of `repro.data.distortion`: numpy only, the same arithmetic and the
same seeded draws, so the output is bit-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import ImageSplits

MAX_SEVERITY = 5

# severity 1..5 parameter tables (index 0 = severity 1)
SEVERITY_PARAMS: Dict[str, List[float]] = {
    "gaussian_noise": [0.2, 0.4, 0.7, 1.1, 1.6],  # sigma, units of image std
    "gaussian_blur": [0.5, 1.0, 1.5, 2.0, 3.0],  # sigma, pixels
    "box_blur": [3, 5, 7, 9, 11],  # box width, pixels (odd)
    "contrast": [0.8, 0.6, 0.45, 0.3, 0.2],  # scale about per-image mean
    "brightness": [0.4, 0.8, 1.2, 1.7, 2.3],  # shift, units of image std
}
DISTORTION_KINDS: Tuple[str, ...] = ("clean",) + tuple(sorted(SEVERITY_PARAMS))


@dataclass(frozen=True)
class DistortionSpec:
    """One point in the taxonomy: (kind, severity). Hashable and orderable
    by its string `key` (``"gaussian_noise@3"``, ``"clean"``), which is what
    `PlanBank` and the serving schedules use as the context key."""

    kind: str
    severity: int = 0

    def __post_init__(self):
        if self.kind == "clean":
            if self.severity != 0:
                raise ValueError("clean admits only severity 0")
            return
        if self.kind not in SEVERITY_PARAMS:
            raise ValueError(
                f"unknown distortion kind {self.kind!r}; "
                f"known: {sorted(DISTORTION_KINDS)}"
            )
        if not 1 <= self.severity <= MAX_SEVERITY:
            raise ValueError(
                f"severity must be 1..{MAX_SEVERITY} for {self.kind!r}, "
                f"got {self.severity}"
            )

    @property
    def key(self) -> str:
        return "clean" if self.kind == "clean" else f"{self.kind}@{self.severity}"

    @property
    def param(self) -> float:
        return 0.0 if self.kind == "clean" else SEVERITY_PARAMS[self.kind][self.severity - 1]

    @classmethod
    def parse(cls, key: str) -> "DistortionSpec":
        if key == "clean":
            return cls("clean", 0)
        kind, _, sev = key.partition("@")
        if not sev:
            raise ValueError(f"expected 'kind@severity' or 'clean', got {key!r}")
        return cls(kind, int(sev))


CLEAN = DistortionSpec("clean")


def _roll_conv1d(x: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """Periodic 1-D convolution along `axis` via weighted np.roll sums."""
    r = len(weights) // 2
    out = np.zeros_like(x)
    for k, w in enumerate(weights):
        out += w * np.roll(x, k - r, axis=axis)
    return out


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(3.0 * sigma + 0.5))
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (t / sigma) ** 2)
    return (w / w.sum()).astype(np.float32)


def _image_stats(x: np.ndarray):
    """Per-image mean/std over (H, W, C); x is (N, H, W, C)."""
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    std = x.std(axis=(1, 2, 3), keepdims=True)
    return mean, np.maximum(std, 1e-6)


def apply_distortion(
    x: np.ndarray, spec: DistortionSpec, seed: int = 0
) -> np.ndarray:
    """Distort a batch of images (N, H, W, C) -> a new float32 array.

    Deterministic: the only stochastic kind (gaussian_noise) draws from
    ``default_rng((seed, severity))``, so the same (x, spec, seed) always
    produces the same output regardless of call order.
    """
    x = np.asarray(x, np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (N, H, W, C) images, got shape {x.shape}")
    if spec.kind == "clean":
        return x.copy()
    p = spec.param
    if spec.kind == "gaussian_noise":
        rng = np.random.default_rng((seed, spec.severity))
        _, std = _image_stats(x)
        return x + (p * std).astype(np.float32) * rng.standard_normal(
            x.shape
        ).astype(np.float32)
    if spec.kind == "gaussian_blur":
        w = _gaussian_kernel(p)
        return _roll_conv1d(_roll_conv1d(x, w, axis=1), w, axis=2)
    if spec.kind == "box_blur":
        w = np.full(int(p), 1.0 / int(p), np.float32)
        return _roll_conv1d(_roll_conv1d(x, w, axis=1), w, axis=2)
    if spec.kind == "contrast":
        mean, _ = _image_stats(x)
        return (mean + p * (x - mean)).astype(np.float32)
    if spec.kind == "brightness":
        _, std = _image_stats(x)
        return (x + p * std).astype(np.float32)
    raise AssertionError(f"unhandled kind {spec.kind!r}")  # guarded in __post_init__


def distort_splits(splits: ImageSplits, spec: DistortionSpec, seed: int = 0) -> ImageSplits:
    """Distort all three image splits (labels untouched). Each split draws
    from its own derived seed so train/val/test noise is independent."""
    return ImageSplits(
        train_x=apply_distortion(splits.train_x, spec, seed=seed * 3 + 0),
        train_y=splits.train_y,
        val_x=apply_distortion(splits.val_x, spec, seed=seed * 3 + 1),
        val_y=splits.val_y,
        test_x=apply_distortion(splits.test_x, spec, seed=seed * 3 + 2),
        test_y=splits.test_y,
    )


# ------------------------------------------------- edge-side input features
FEATURE_NAMES: Tuple[str, ...] = ("mean", "std", "lap_var", "tv")


def input_features(x: np.ndarray) -> np.ndarray:
    """Cheap per-image statistics -> (N, 4) float64, columns FEATURE_NAMES.

    * ``mean`` / ``std``   -- pixel moments (brightness / contrast axes);
    * ``lap_var``          -- variance of the 4-neighbor Laplacian: collapses
                              under blur, explodes under additive noise;
    * ``tv``               -- mean absolute first difference (total
                              variation), a second blur/noise axis with a
                              different severity response than lap_var.

    This is the whole edge-side "distortion classifier" input: a few numpy
    reductions per image, no learned feature extractor.
    """
    x = np.asarray(x, np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (N, H, W, C) images, got shape {x.shape}")
    mean = x.mean(axis=(1, 2, 3))
    std = x.std(axis=(1, 2, 3))
    lap = (
        4.0 * x
        - np.roll(x, 1, axis=1)
        - np.roll(x, -1, axis=1)
        - np.roll(x, 1, axis=2)
        - np.roll(x, -1, axis=2)
    )
    lap_var = lap.var(axis=(1, 2, 3))
    tv = 0.5 * (
        np.abs(x - np.roll(x, 1, axis=1)).mean(axis=(1, 2, 3))
        + np.abs(x - np.roll(x, 1, axis=2)).mean(axis=(1, 2, 3))
    )
    return np.stack([mean, std, lap_var, tv], axis=1).astype(np.float64)


def default_contexts(
    kinds: Sequence[str] = ("gaussian_noise", "gaussian_blur", "contrast"),
    severities: Sequence[int] = (3,),
    include_clean: bool = True,
) -> List[DistortionSpec]:
    """A compact context set for experiments: clean + each kind at the
    given severities (the Pacheco setup keeps one expert per kind)."""
    specs = [CLEAN] if include_clean else []
    specs += [DistortionSpec(k, s) for k in kinds for s in severities]
    return specs
