"""PyTorch + CUDA port of `repro`, for one NVIDIA H100 (Hopper, sm_90a).

The module layout mirrors `repro`: every module here has exactly one
reference module there. The port imports neither `jax` nor `repro`; the
parity tests under `tests/test_torch_*.py` are the only code that imports
both.

Device rule: entry points (`offload.engine.convnet_engine`,
`models.convnet.init_params`, `core.policy.make_plan`,
`core.bank.fit_bank`, `core.control.rescore_plan`,
`offload.simulator.simulate_batches`, the `training.loop` steps,
`kernels.ops.*`, and the default ``"torch"`` gate backend) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without that request they raise instead of carrying on on the CPU.
Functions that take tensors follow the tensors' device. Kernel wrappers
send a CPU tensor to the plain PyTorch version and a CUDA tensor to the
hand-written kernel in `csrc/` -- never the plain version on the card.
"""
