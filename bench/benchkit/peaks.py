"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit): the denominators of every roofline and ``mfu`` share."""

#: FLOP/s by the precision the configuration runs in; float32 is the
#: non-tensor-core rate, since the benchmark turns TF32 off
FLOPS = {"bfloat16": 989e12, "float32": 67e12}

#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
