"""Hand-written CUDA kernels (sources in `repro_torch/csrc/`) with their
plain PyTorch versions (`ref.py`) and thin wrappers (`ops.py`,
`compress.py`). Port of `repro.kernels`: K1 `exit_gate`, K2 `calib_nll`,
K3/K4 the uplink codec `encode` / `decode`; and K5 `qk_rope`, qk-norm and
RoPE at inference, which no Pallas kernel of the reference computes.
"""
