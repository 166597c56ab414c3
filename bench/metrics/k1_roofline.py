"""K1's share of its roofline: the bytes the gate needs per call (the exit
logits of a batch's rows read once; a float32 confidence, a float32
entropy and an int32 prediction a row written once) over the card's HBM
bandwidth, over K1's mean device time per launch by kernel name in the
trace. Nothing to read without a trace or a K1 launch."""
from benchkit import peaks
from benchkit.trace import kernel_time

#: K1's kernels (`csrc/exit_gate.cu`), by the names the trace gives them
KERNELS = ("gate_group_kernel", "gate_warp_kernel", "gate_block_kernel")
#: bytes written a row: confidence, entropy, prediction
OUT_BYTES = 12


def read(record):
    if record["trace"] is None:
        return None
    calls, seconds = kernel_time(record["trace"], KERNELS)
    if not calls or seconds <= 0:
        return None
    rows = record["rows"]
    nbytes = rows * record["classes"] * record["logit_bytes"] + rows * OUT_BYTES
    bound = nbytes / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / (seconds / calls)
