"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W): the yardstick's denominators, as
chip_smoke.py (commit 70823ee) states them."""

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores; an FMA counts as two
