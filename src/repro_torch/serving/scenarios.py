"""Reference serving scenarios shared by the acceptance tests and the
benchmark suite, so the scenario CI asserts on and the scenario the tests
pin down cannot silently drift apart.

`synthetic_cascade_logits` is a deterministic stand-in for a trained
two-exit B-AlexNet's logits: branch 1 moderately confident, branch 2
strictly more confident on the same samples, and a near-oracle cloud main
head. `run_congested_markov` is the congestion acceptance scenario: a
Poisson fleet against a mostly-bad Markov Wi-Fi link, served either by the
static plan or with the online controller re-scoring it.

`synthetic_distorted_cascade` + `run_distortion_drift` are the input-drift
acceptance scenario: the same cascade pushed through the distortion
taxonomy of `repro_torch.data.distortion`. Images and the edge-side features the
estimator sees are REAL (cifar_like frames, really distorted); the logits
are a documented synthetic stand-in whose miscalibration grows with
severity -- margins shrink while logit magnitudes grow, the overconfident
failure mode Pacheco et al. (2108.09343) measure on trained networks. A
single temperature fit on clean data therefore under-corrects distorted
regimes, which is exactly the gap the expert `PlanBank` closes.

Port of `repro.serving.scenarios`. The data generators are the
reference's numpy, draw for draw. Every scenario runs its cores and
controller on one ``"torch"`` gate backend on `device` (``cuda`` unless
the caller names the CPU; without a GPU it raises).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bank import fit_bank
from repro_torch.core.gatepath import TorchGateBackend
from repro_torch.core.policy import OffloadPlan, make_plan
from repro_torch.data.distortion import (
    DistortionSpec,
    apply_distortion,
    input_features,
)
from repro_torch.offload import latency as L
from repro_torch.serving.controller import ControllerConfig, OnlineController
from repro_torch.serving.drift import ContextualLogitsCore, MarkovContextSchedule
from repro_torch.serving.network import MarkovNetwork
from repro_torch.serving.runtime import LogitsCore, RuntimeConfig, ServingRuntime
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.workload import poisson_workload


def synthetic_cascade_logits(
    n: int = 512, c: int = 10, seed: int = 0
) -> Tuple[Dict[int, np.ndarray], np.ndarray, np.ndarray]:
    """-> ({1: z1, 2: z2}, final_logits, labels)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    z1 = (rng.normal(size=(n, c)) * 2).astype(np.float32)
    z1[np.arange(n), y] += 3.0
    z2 = z1.copy()
    z2[np.arange(n), y] += 2.0
    final = np.zeros((n, c), np.float32)
    final[np.arange(n), y] = 9.0
    return {1: z1, 2: z2}, final, y


def congested_markov_network(
    good_bps: float = 18.8e6, bad_bps: float = 1.5e6
) -> MarkovNetwork:
    """The paper's nominal link that spends most of its time degraded."""
    return MarkovNetwork(
        good_bps=good_bps, bad_bps=bad_bps,
        p_good_to_bad=0.5, p_bad_to_good=0.1,
        dwell_s=1.0, seed=1, start_state=1,
    )


def run_congested_markov(
    plan: OffloadPlan,
    exit_logits: Dict[int, np.ndarray],
    final_logits: np.ndarray,
    labels: np.ndarray,
    n_requests: int = 800,
    arrival_rate_hz: float = 80.0,
    deadline_s: float = 0.1,
    with_controller: bool = False,
    controller_config: Optional[ControllerConfig] = None,
    profile: Optional[L.LatencyProfile] = None,
    obs=None,
    device=None,
) -> Telemetry:
    profile = profile or L.paper_2020()
    backend = TorchGateBackend(device=device)
    core = LogitsCore(exit_logits, final_logits, plan, labels=labels,
                      device=backend.device)
    reqs = poisson_workload(
        arrival_rate_hz, n_requests, len(labels), deadline_s=deadline_s, seed=2
    )
    controller = None
    if with_controller:
        controller = OnlineController(
            plan, profile, exit_logits, final_logits=final_logits,
            labels=labels,
            config=controller_config
            or ControllerConfig(interval_s=0.5, window_s=1.0, min_accuracy=0.9),
            backend=backend,
        )
    rt = ServingRuntime(
        core, profile, plan, reqs,
        network=congested_markov_network(),
        config=RuntimeConfig(max_batch=4, batch_window_s=0.02),
        controller=controller, obs=obs,
    )
    return rt.run()


# ------------------------------------------------------------ input drift
def drift_contexts() -> List[DistortionSpec]:
    """The reference context set: clean + one expert-worthy regime per
    distortion family, at staggered severities so the experts genuinely
    differ from one another (not just from the clean fit)."""
    return [
        DistortionSpec("clean"),
        DistortionSpec("gaussian_noise", 2),
        DistortionSpec("gaussian_blur", 3),
        DistortionSpec("contrast", 4),
    ]


def synthetic_distorted_cascade(
    contexts: Optional[List[DistortionSpec]] = None,
    n: int = 1024,
    n_val: int = 1024,
    c: int = 10,
    seed: int = 0,
    directions: Optional[Dict[str, str]] = None,
) -> Tuple[dict, dict]:
    """-> (val, test) per-context cascade data for the drift scenario.

    Each dict has keys ``exit_logits`` ({ctx: {1: z1, 2: z2}}), ``final``
    ({ctx: (N, C)}), ``features`` ({ctx: (N, F)} -- input_features of the
    REALLY distorted cifar_like images), and ``labels`` ((N,) shared across
    contexts: the same base samples, distorted).

    The logit model (a stand-in for a trained B-AlexNet under distortion,
    severity s; the distortion KIND shapes only the real images/features):

    * each sample carries a margin d ~ U(2, 9) and an aleatoric accuracy
      ceiling q(d) = 1 - 0.6 exp(-0.18 d) -- the branch's perceived class
      is the label with probability q, a confusable class otherwise, so
      even confident samples top out near-but-above p_tar rather than at
      1.0 (the paper's ~80%-accuracy CIFAR regime);
    * severity marks a growing fraction phi(s) = 0.2 + 0.12 s of samples
      as AFFECTED: their perceived class is re-drawn near chance (the
      branch is fooled) and their margin collapses to 0.45 d (the
      evidence genuinely weakens);
    * every logit is scaled by 1.4 (1 + 0.5 s): the head is overconfident
      on clean inputs (clean T fits ~2.3, the paper's Fig. 2 regime) and
      gets MORE overconfident as inputs degrade -- Pacheco et al.'s
      observation, and the reason one clean-fit temperature under-corrects
      every distorted regime.

    `directions` optionally flips individual distortion KINDS to the
    UNDERCONFIDENT drift the trained model of
    ``examples/offload_under_distortion.py`` exhibits: severity then
    deflates the logit scale to 1.4 / (1 + 0.6 s) while the affected
    fraction stays small (phi = 0.05 + 0.03 s) -- accuracy barely moves
    but confidence evaporates, so a clean-fit gate starves the edge and
    floods the uplink for no reliability gain, and the matching expert
    re-SHARPENS (expert T below the clean fit). Keys are distortion kinds
    (``{"gaussian_blur": "under"}``), value ``"over"`` (the default) or
    ``"under"``. Omitting the argument reproduces the pre-existing
    all-overconfident data bit-for-bit.

    All per-sample draws happen ONCE per split and are shared by every
    context, so plan comparisons see purely the systematic severity
    effect, never different noise realizations.
    """
    from repro_torch.data.synthetic import cifar_like

    contexts = drift_contexts() if contexts is None else contexts
    directions = directions or {}
    unknown_dir = set(directions.values()) - {"over", "under"}
    if unknown_dir:
        raise ValueError(f"directions must be 'over'/'under', got {unknown_dir}")
    unknown_kind = set(directions) - {spec.kind for spec in contexts}
    if unknown_kind:  # a typoed kind must not silently measure the default
        raise ValueError(
            f"directions name kinds absent from the context set: "
            f"{sorted(unknown_kind)}"
        )
    rng = np.random.default_rng(seed)
    images = cifar_like(n_train=8, n_val=n_val, n_test=n, seed=seed + 1)

    def perceived(y, ok_prob, rng, m):
        """The class a branch head locks onto: the label w.p. ok_prob,
        else a confusable other class."""
        ok = rng.random(m) < ok_prob
        confused = (y + rng.integers(1, c, m)) % c
        return np.where(ok, y, confused)

    def make_split(m, img_x, img_seed):
        y = rng.integers(0, c, m)
        base = (rng.normal(size=(m, c)) * 1.2).astype(np.float32)
        d = rng.uniform(2.0, 9.0, m).astype(np.float32)
        u = rng.random(m)  # severity-affected position (nested: s' > s)
        q1 = 1.0 - 0.6 * np.exp(-0.18 * d)
        q2 = 1.0 - 0.45 * np.exp(-0.18 * d)  # the deeper exit sees more
        views = {
            1: (perceived(y, q1, rng, m), perceived(y, 0.35, rng, m), 1.0),
            2: (perceived(y, q2, rng, m), perceived(y, 0.5, rng, m), 1.2),
        }
        out = {"exit_logits": {}, "final": {}, "features": {}, "labels": y}
        idx = np.arange(m)
        for spec in contexts:
            s = spec.severity
            if directions.get(spec.kind, "over") == "under" and s:
                # underconfident drift: evidence survives, magnitude doesn't
                affected = u < 0.05 + 0.03 * s
                scale = 1.4 / (1.0 + 0.6 * s)
            else:
                affected = u < (0.2 + 0.12 * s if s else 0.0)
                scale = 1.4 * (1.0 + 0.5 * s)
            per_branch = {}
            for b, (c_clean, c_dist, dmul) in views.items():
                z = base.copy()
                z[idx, np.where(affected, c_dist, c_clean)] += np.where(
                    affected, 0.45 * d, d
                ) * dmul
                per_branch[b] = (z * scale).astype(np.float32)
            final = np.zeros((m, c), np.float32)
            final[idx, y] = 9.0 * (1.0 - 0.03 * s)
            out["exit_logits"][spec.key] = per_branch
            out["final"][spec.key] = final
            out["features"][spec.key] = input_features(
                apply_distortion(img_x, spec, seed=img_seed)
            )
        return out

    val = make_split(n_val, images.val_x, img_seed=seed + 11)
    test = make_split(n, images.test_x, img_seed=seed + 12)
    return val, test


def fit_drift_plans(val: dict, p_tar: float = 0.8, device=None):
    """-> (uncalibrated, global single, expert bank) fit on the val split
    (the fits run on `device`, ``cuda`` unless the caller names the CPU).

    * uncalibrated: identity calibrators (the conventional-DNN baseline);
    * global: ONE temperature pair fit on the CLEAN validation logits (the
      paper's procedure, blind to distortion);
    * bank: one expert plan per context + the feature estimator.
    """
    clean = val["exit_logits"]["clean"]
    y = val["labels"]
    uncal = make_plan([clean[1], clean[2]], y, p_tar=p_tar, calibrated=False,
                      device=device)
    global_plan = make_plan([clean[1], clean[2]], y, p_tar=p_tar, device=device)
    bank = fit_bank(
        {ctx: [z[1], z[2]] for ctx, z in val["exit_logits"].items()},
        y,
        p_tar=p_tar,
        default_context="clean",
        features_by_context=val["features"],
        device=device,
    )
    return uncal, global_plan, bank


def drift_controller_config(
    interval_s: float = 1.0,
) -> ControllerConfig:
    """The reference controller configuration for the drift scenario's
    controller arms -- shared by the acceptance test and the distortion
    bench so the config CI asserts under and the config the tests pin
    down are the same object.

    The p_tar grid and the reliability-gap cap are what give a
    context-aware re-score something to use: under overconfident drift
    the gap-minimizing effective p_tar is context-dependent (high on
    clean inputs, low on heavily distorted ones), so a controller that
    prices candidates on the OBSERVED mix can track it while the
    clean-validation-only re-score, whose gap estimates are always tiny,
    cannot. The accuracy floor is deliberately below the clean floor:
    holding the paper's reliability contract under heavy distortion
    costs end-to-end accuracy, and a floor at the clean level would
    forbid exactly the honest low-p_tar candidates the contract needs.
    """
    return ControllerConfig(
        interval_s=interval_s,
        window_s=2.0 * interval_s,
        min_accuracy=0.75,
        p_tar_grid=(0.5, 0.6, 0.7, 0.8, 0.9),
        max_reliability_gap=0.05,
    )


def severity_drift_schedule(
    contexts: Optional[List[DistortionSpec]] = None,
    dwell_s: float = 3.0,
    seed: int = 10,
) -> MarkovContextSchedule:
    """Markov regime drift over the reference contexts, starting clean.
    The default (dwell, seed) pair visits ALL four regimes within the
    ~37 s the reference 1500-request workload spans."""
    contexts = drift_contexts() if contexts is None else contexts
    return MarkovContextSchedule(
        [spec.key for spec in contexts],
        dwell_s=dwell_s, p_stay=0.5, seed=seed, start_context="clean",
    )


def run_distortion_drift(
    plan_or_bank,
    test: dict,
    schedule=None,
    n_requests: int = 1500,
    arrival_rate_hz: float = 40.0,
    deadline_s: float = 0.1,
    with_controller: bool = False,
    val: Optional[dict] = None,
    profile: Optional[L.LatencyProfile] = None,
    controller_interval_s: float = 1.0,
    context_aware: bool = False,
    controller_config: Optional[ControllerConfig] = None,
    obs=None,
    device=None,
) -> Telemetry:
    """Serve `test` under severity drift with a plan or an expert bank.

    The network is the paper's fixed link: holding bandwidth constant
    isolates the input-drift axis, so any miscalibration-gap difference
    between plans is attributable to calibration alone. with_controller
    (needs `val`) layers the Edgent-style re-scorer on top, demonstrating
    that bandwidth-driven (branch, p_tar) moves compose with
    distortion-driven expert selection; `controller_interval_s` sets its
    cadence (the dwell-vs-interval bench sweeps it against the schedule's
    dwell time).

    `context_aware` switches the controller from the CLEAN-validation-only
    re-score (the original arm: candidate tables priced on clean logits,
    blind to drift) to the fleet's mix-weighted rule ported back to the
    event runtime: the controller receives ALL contexts' validation
    logits and each tick weights them by the traffic mix its own
    telemetry observed over the trailing window, so candidate offload
    probabilities, accuracies, and reliability gaps price the inputs
    actually being served. `controller_config` overrides the reference
    controller configuration (shared by both arms so the information,
    not the knobs, is the difference).
    """
    profile = profile or L.paper_2020()
    backend = TorchGateBackend(device=device)
    schedule = severity_drift_schedule() if schedule is None else schedule
    core = ContextualLogitsCore(
        test["exit_logits"], test["final"], plan_or_bank, schedule,
        labels=test["labels"], features_by_context=test["features"],
        backend=backend,
    )
    reqs = poisson_workload(
        arrival_rate_hz, n_requests, core.n_samples,
        deadline_s=deadline_s, seed=7,
    )
    controller = None
    if with_controller:
        if val is None:
            raise ValueError("with_controller needs the val split")
        config = controller_config or ControllerConfig(
            interval_s=controller_interval_s,
            window_s=2.0 * controller_interval_s,
            min_accuracy=0.85,
        )
        if context_aware:  # all contexts' val logits -> mix-weighted tables
            exit_logits, final_logits = val["exit_logits"], val["final"]
        else:  # the original clean-validation-only re-score
            exit_logits = val["exit_logits"]["clean"]
            final_logits = val["final"]["clean"]
        controller = OnlineController(
            plan_or_bank, profile, exit_logits,
            final_logits=final_logits, labels=val["labels"],
            config=config, backend=backend,
        )
    rt = ServingRuntime(
        core, profile, plan_or_bank, reqs,
        config=RuntimeConfig(max_batch=4, batch_window_s=0.02),
        controller=controller, obs=obs,
    )
    return rt.run()
