"""TPU kernel 5, ``pull_ms_packed`` (``csrc/ms_pull.cuh``'s mask instance,
built in ``csrc/blest_ms.cu``): the packed multi-source pull.  It reads the
masks (tau bytes a VSS), the frontier words (sigma x kw words a slice set)
and v2r (4 bytes a VSS), and writes kw mark words a slice; a slice costs
sigma selective ORs of kw words, 2 tau sigma kw operations a VSS.  The
figures of ``chip_smoke.py``'s ``packed_pull_cell``.

``pull_ms_packed_run`` is also the device function of kernel 9, the queued
instance (``csrc/blest_serve.cu``), which only the serve engine launches;
its wrapper is another, so a cell that ran both would take kernel 5's
bound for kernel 9's launches too."""

WRAPPER = ("repro_torch.kernels.pull_ms_packed", "pull_ms_packed")
DEVICE_FUNCTIONS = ("pull_ms_packed_run",)


def counts(masks, f_packed, v2r, sigma=8):
    n_v, tau = masks.shape
    s1, sig, kw = f_packed.shape
    nbytes = n_v * tau + 4 * s1 * sig * kw + 4 * n_v + 4 * n_v * tau * kw
    return nbytes, 2 * n_v * tau * sig * kw, "alu"
