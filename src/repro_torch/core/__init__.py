"""The paper's contribution as a composable library (port of `repro.core`).

The pipeline: run a validation pass over the early-exit network, fit a
`Calibrator` per exit, bundle the resulting `CalibratorState`s with the
gating criterion, `p_tar` and the chosen partition point into an
`OffloadPlan`, serialize it to JSON, and hand it to the serving engine.

  exits        confidence gating (max-softmax / entropy) + cascades; on
               the card every gate runs the fused K1 kernel
  calibration  the Calibrator protocol + registry: Temperature Scaling
               (paper Eq. 2), vector scaling, identity baseline
  policy       OffloadPlan -- the deployable artifact, same JSON schema
               as `repro`
  bank         PlanBank -- one expert OffloadPlan per input-distortion
               context + the cheap edge-side DistortionEstimator that
               picks the expert per batch; same JSON contract as plans
  gatepath     the shared gate execution layer: GateBackend (host numpy /
               the card, "torch") + the dense GateTable
  control      the shared controller core: rescore_plan candidate tables,
               feasibility/hysteresis/concession rules, ControllerCore,
               and the telemetry primitives
  partition    adaptive partition-point selection (expected-latency
               optimal); select_partition writes the choice into the plan
  metrics      ECE, reliability diagrams, inference outage

Exports what the reference exports, with `TorchGateBackend` in place of
`JaxGateBackend`.
"""
from repro_torch.core.bank import (  # noqa: F401
    UNKNOWN_CONTEXT,
    DistortionEstimator,
    PlanBank,
    fit_bank,
)
from repro_torch.core.calibration import (  # noqa: F401
    Calibrator,
    CalibratorState,
    apply_calibrator,
    available_calibrators,
    calibrate_cascade,
    fit_temperature,
    get_calibrator,
    register_calibrator,
)
from repro_torch.core.control import (  # noqa: F401
    ControlConfig,
    ControllerCore,
    choose_with_concession,
    hold_incumbent,
    latency_stats_ms,
    on_device_gap,
    row_feasible,
    select_candidate,
    windowed_mean,
    windowed_mix,
    windowed_rate,
)
from repro_torch.core.exits import apply_gate, cascade_gate, gate_statistics  # noqa: F401
from repro_torch.core.gatepath import (  # noqa: F401
    STATIC_CONTEXT,
    GateBackend,
    GateTable,
    NumpyGateBackend,
    TorchGateBackend,
    available_gate_backends,
    get_gate_backend,
    register_gate_backend,
)
from repro_torch.core.metrics import (  # noqa: F401
    ece,
    inference_outage_probability,
    outage_probability_cascade,
    overall_accuracy,
    reliability_diagram,
)
from repro_torch.core.partition import choose_partition, select_partition  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    OffloadPlan,
    OffloadPolicy,
    make_plan,
    make_policy,
    rescore_plan,
)
