"""TPU kernel 4, ``pull_ms`` (``csrc/blest_ms.cu``): the byteplane
multi-source pull.  It reads the masks (tau bytes a VSS), the frontier
planes (sigma x kappa bytes a slice set) and v2r (4 bytes a VSS), and
writes kappa mark bytes a slice; the product is 2 tau sigma kappa
operations a VSS at the int8 tensor-core rate.  The figures of
``chip_smoke.py``'s ``pull_ms_cell``."""

WRAPPER = ("repro_torch.kernels.pull_ms", "pull_ms")
DEVICE_FUNCTIONS = ("pull_ms_kernel",)


def counts(masks, f_planes, v2r, sigma=8):
    n_v, tau = masks.shape
    s1, sig, kappa = f_planes.shape
    nbytes = n_v * tau + s1 * sig * kappa + 4 * n_v + n_v * tau * kappa
    return nbytes, 2 * n_v * tau * sig * kappa, "int8_mma"
