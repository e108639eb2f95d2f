"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12      # HBM3 bandwidth
ALU_OPS_PER_S = 67e12          # float32 rate of the CUDA cores: the highest
                               # rate a scalar integer kernel could issue at
INT8_MMA_OPS_PER_S = 1979e12   # dense int8 tensor-core rate
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core rate

PEAKS = {"alu": ALU_OPS_PER_S, "int8_mma": INT8_MMA_OPS_PER_S,
         "bf16": BF16_FLOPS_PER_S}


def bound_s(nbytes: float, ops: float, peak: str) -> float:
    """The least time the card could take: bytes over the bandwidth or
    operations over the peak rate, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAKS[peak])
