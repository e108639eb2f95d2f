"""TPU kernel 2, ``pull_ss_packed`` (``csrc/blest_ss.cu``): the packed
single-source pull.  One launch reads every mask word once (tau bytes a VSS)
and its VSS's alpha byte, and writes one mark byte a slice; a slice costs
7/4 operations (the carry trick on a 32-bit word of four slices).  The
figures of ``chip_smoke.py``'s production rows."""

WRAPPER = ("repro_torch.kernels.pull_ss", "pull_ss_packed")
DEVICE_FUNCTIONS = ("pull_ss_packed_kernel",)


def counts(masks_packed, alphas):
    n_v, words = masks_packed.shape
    tau = 4 * words
    return 2 * n_v * tau + n_v, 7 * n_v * tau // 4, "alu"
