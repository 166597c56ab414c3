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
  partition    adaptive partition-point selection (expected-latency
               optimal); select_partition writes the choice into the plan
  metrics      ECE, reliability diagrams, inference outage

Exports only what has been ported; `bank`, `gatepath` and `control` wait
for the serving slice.
"""
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
from repro_torch.core.exits import apply_gate, cascade_gate, gate_statistics  # noqa: F401
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
    make_plan,
)
