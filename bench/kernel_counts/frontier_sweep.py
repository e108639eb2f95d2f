"""TPU kernel 3, ``frontier_sweep`` (``csrc/blest_ss.cu``): Stage 2 of a
single-source level.  Over n vertices it reads v_curr, v_next (a byte each)
and the level (4 bytes), writes v_out and the level, and writes a frontier
word and an activity byte a slice set: 11 n + 2 n / sigma bytes, 5
operations a vertex.  Both of its device functions (16-vertex items, and the
slice-set loop for unaligned views) do that work.  The figures of
``chip_smoke.py``'s production rows."""

WRAPPER = ("repro_torch.kernels.frontier_sweep", "frontier_sweep")
DEVICE_FUNCTIONS = ("frontier_sweep_items", "frontier_sweep_sets")


def counts(v_curr, v_next, level, ell, sigma=8):
    (n,) = v_curr.shape
    return 11 * n + 2 * (n // sigma), 5 * n, "alu"
