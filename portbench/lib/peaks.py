"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), the table the benchmark's roofline shares are taken against.
They hold at the card's full power limit; every traced run prints the
card's limit beside its shares."""

HBM_BYTES_PER_S = 3.35e12       # HBM3, 80 GB part
INT32_OPS_PER_S = 67e12         # integer / float32 outside the tensor cores
POWER_LIMIT_W = 700.0           # the limit the peaks assume
