"""The redesigned pull_ss (kernel 1) of the PyTorch port, on the CPU.

The kernel runs only on a GPU, where chip_smoke.py holds it against its
plain version.  What of it runs here:

- a numpy model of the launcher's per-call choice (``blest_pull_ss`` in
  ``csrc/blest_ss.cu``): the item kernel where tau % 16 == 0 and masks and
  marks are 16-byte aligned, the byte kernel otherwise;
- a model of the item kernel's map on the geometry the source states (its
  constexprs, read from the file): kPullItems items of 16 bytes a thread,
  kPullThreads apart, a grid of at most one wave of blocks looping over
  chunks; every item, so every output byte, written exactly once for the
  pool's shapes (tau in {1, 2, 4, 16, 128}, ragged N_v, views at element
  1) and for kron-22's (806,384, 128), for any wave;
- a model of the byte kernel's grid-stride loop, whose (row, column) is
  advanced by the stride with no division: every byte once, and the row
  equal to i // tau at every step;
- the item arithmetic (the alpha broadcast to four bytes, the carry trick
  on the item's four little-endian words) against the port's
  ``pull_ss_ref`` and ``repro``'s ``pull_ss_ref`` and Pallas ``pull_ss`` in
  interpret mode, on seeded bytes of any value, all-zero alphas included;
- the wrapper's contract on the CPU.

Outputs are bytes: equality is exact (tolerance 0).
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypothesis_shim import given_seeds  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pull_ss as t_pull  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

CSRC = pathlib.Path(t_pull.__file__).parent / "csrc"
CASES = 12
J_REF = jax.jit(j_ref.pull_ss_ref)
KRON22 = (806_384, 128)  # chip_smoke.py's kron-22 BVSS: N_v, tau
H100_WAVE = 132 * 8  # 132 SMs, 8 resident blocks of 256 threads each


def _constexprs(name):
    """The numeric constexprs of a CUDA source (``kThreads = 256``,
    ``kMaxBlocks = 132 * 16``, ...)."""
    text = (CSRC / name).read_text()
    return {k: int(np.prod([int(x) for x in expr.split("*")]))
            for k, expr in re.findall(r"constexpr (?:int|int64_t) (\w+) = "
                                      r"([\d *]+);", text)}


SS = _constexprs("blest_ss.cu")
ITEM = SS["kPullItemBytes"]
CHUNK = SS["kPullThreads"] * SS["kPullItems"]  # items a block's pass


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _path(tau, masks_off, marks_off):
    """The launcher's choice from tau and the pointers' byte offsets."""
    if tau % ITEM or masks_off % ITEM or marks_off % ITEM:
        return "bytes"
    return "items"


def _pull_words(words, a):
    """The item kernel's arithmetic on (items, 4) uint32 words and each
    item's alpha byte: per byte, 1 where byte & alpha != 0."""
    a4 = a.astype(np.uint32) * np.uint32(0x01010101)
    t = words & a4[:, None]
    nz = ((t & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | t
    return (nz >> np.uint32(7)) & np.uint32(0x01010101)


def _items_model(masks, alphas, wave, *, values=True):
    """The item kernel over (N_v, tau) masks on a grid of min(chunks, wave)
    blocks: each block's threads take kPullItems items kPullThreads apart
    in each chunk of its grid-stride loop.  Returns the marks (or None
    without ``values``), how often each item was written, and the blocks."""
    n_v, tau = masks.shape
    items = n_v * tau // ITEM
    row_items = tau // ITEM
    shift = {1: 0, 2: 1, 4: 2, 8: 3}.get(row_items)  # template instances
    threads, k_items = SS["kPullThreads"], SS["kPullItems"]
    chunks = -(-items // CHUNK)
    blocks = min(chunks, wave)
    words = masks.reshape(-1).view("<u4").reshape(items, 4)
    out = np.full((items, 4), 0xABABABAB, np.uint32) if values else None
    hits = np.zeros(items, np.int64)
    b = np.arange(blocks)[:, None, None]
    k = np.arange(k_items)[None, :, None]
    t = np.arange(threads)[None, None, :]
    for step in range(-(-chunks // blocks)):  # the grid-stride loop
        i0 = (b + step * blocks) * CHUNK + t + 0 * k  # the loop variable
        i = i0 + k * threads
        i = i[(i0 < items) & (i < items)]
        hits[i] += 1  # distinct within a step
        if values:
            row = i >> shift if shift is not None else i // row_items
            out[i] = _pull_words(words[i], alphas[row])
    marks = out.view(np.uint8).reshape(n_v, tau) if values else None
    return marks, hits, blocks


def _byte_stride(total):
    """The byte kernel's grid: kThreads a block, at most kMaxBlocks."""
    threads = SS["kThreads"]
    return min(-(-total // threads), SS["kMaxBlocks"]) * threads


def _byte_rows(total, tau, threads_of=None):
    """The byte kernel's grid-stride loop: yields (i, row) at each step for
    the threads ``threads_of`` of its grid (all of them by default), with
    the row and column advanced by the stride as the kernel does, and
    checks them against i // tau and i % tau."""
    stride = _byte_stride(total)
    i = np.arange(stride) if threads_of is None else threads_of
    i = i[(i < stride) & (i < total)]
    row, col = i // tau, i % tau
    step_rows, step_cols = divmod(stride, tau)
    while len(i):
        assert (row == i // tau).all() and (col == i % tau).all()
        yield i, row
        i, row, col = i + stride, row + step_rows, col + step_cols
        wrap = col >= tau
        col[wrap] -= tau
        row[wrap] += 1
        live = i < total
        i, row, col = i[live], row[live], col[live]


def _bytes_model(masks, alphas):
    """The byte kernel: the marks and how often each byte was written."""
    flat = masks.reshape(-1)
    out = np.full(flat.size, 0xAB, np.uint8)
    hits = np.zeros(flat.size, np.int64)
    for i, row in _byte_rows(flat.size, masks.shape[1]):
        out[i] = (flat[i] & alphas[row]) != 0
        hits[i] += 1
    return out.reshape(masks.shape), hits


def _model(masks, alphas, masks_off=0, marks_off=0, wave=H100_WAVE):
    """kernel 1 as the launcher of csrc/blest_ss.cu runs it: the marks, the
    writes of each output byte and the path."""
    tau = masks.shape[1]
    path = _path(tau, masks_off, marks_off)
    if path == "bytes":
        marks, hits = _bytes_model(masks, alphas)
        return marks, hits, path
    marks, hits, _ = _items_model(masks, alphas, wave)
    return marks, np.repeat(hits, ITEM), path


def _inputs(rng, n_v, tau):
    """Masks of any byte value; alphas of any value, all zero in ~15% of
    draws (an empty frontier)."""
    masks = rng.integers(0, 256, (n_v, tau), dtype=np.uint8)
    alphas = rng.integers(0, 256, n_v, dtype=np.uint8)
    if rng.random() < 0.15:
        alphas[:] = 0
    return masks, alphas


def _refs(masks, alphas, *, interpret=True):
    """The port's plain version, repro's reference and (unless not asked)
    repro's Pallas kernel in interpret mode."""
    out = [ops.pull_ss(torch.from_numpy(masks), torch.from_numpy(alphas)),
           J_REF(jnp.asarray(masks), jnp.asarray(alphas))]
    if interpret:
        out.append(j_ops.pull_ss(jnp.asarray(masks), jnp.asarray(alphas),
                                 use_pallas=True, interpret=True))
    return out


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_item_geometry():
    """16-byte items, whole warps, 1-4 items a thread (the A/B tool's
    choices); at kron-22's shape 6,451,072 items in 6,451,072 / CHUNK
    chunks, an item never straddles a row, and its row is i >> 3."""
    assert ITEM == 16 and SS["kPullThreads"] % 32 == 0
    assert SS["kPullItems"] in (1, 2, 4)
    n_v, tau = KRON22
    assert n_v * tau // ITEM == 6_451_072 < t_pull.MAX_ITEMS
    assert tau % ITEM == 0 and tau // ITEM == 1 << 3


@pytest.mark.parametrize("tau,masks_off,marks_off,path", [
    (1, 0, 0, "bytes"), (2, 0, 0, "bytes"), (4, 0, 0, "bytes"),
    (8, 0, 0, "bytes"), (48, 0, 0, "items"), (16, 0, 0, "items"),
    (128, 0, 0, "items"), (128, 1, 0, "bytes"), (128, 0, 4, "bytes"),
    (128, 128, 0, "items"), (16, 16, 32, "items"), (4, 4, 0, "bytes")])
def test_launcher_choice(tau, masks_off, marks_off, path):
    """The item kernel only where every item lies in one row and both
    vector pointers are 16-byte aligned; the byte kernel elsewhere."""
    assert _path(tau, masks_off, marks_off) == path


POOL = [(tau, n_v) for tau in (1, 2, 4, 16, 128)
        for n_v in (1, 37, -(-CHUNK * ITEM // tau) + 1)]


@pytest.mark.parametrize("tau,n_v", POOL)
def test_pool_writes_every_byte_once(tau, n_v):
    """From aligned tensors and from views at element 1 (masks one byte
    in): every output byte written exactly once, on the path the launcher
    picks, for a one-wave grid and grids of 1 and 3 blocks; the marks equal
    the port's plain version, repro's reference and its Pallas kernel in
    interpret mode, on any bytes."""
    rng = np.random.default_rng(n_v * 1000 + tau)
    masks, alphas = _inputs(rng, n_v, tau)
    refs = _refs(masks, alphas)
    paths = set()
    for masks_off, wave in ((0, H100_WAVE), (0, 1), (0, 3), (1, H100_WAVE)):
        got, hits, path = _model(masks, alphas, masks_off, 0, wave)
        paths.add(path)
        assert (hits == 1).all()
        for want in refs:
            _eq(got, want)
    assert paths == ({"items", "bytes"} if tau % ITEM == 0 else {"bytes"})
    # the view itself, through ops: the plain version on the CPU
    buf = torch.from_numpy(np.concatenate([[7], masks.reshape(-1)])
                           .astype(np.uint8))
    view = buf[1:].view(n_v, tau)
    assert view.storage_offset() == 1 and view.is_contiguous()
    _eq(ops.pull_ss(view, torch.from_numpy(alphas)), refs[0])


def test_kron22_item_map():
    """kron-22's (806,384, 128) masks: the item kernel (tau = 128, fresh
    tensors) writes each of the 6,451,072 items once for a one-wave grid
    and for a 7-block grid, and its marks equal the port's plain version
    and repro's reference on any bytes; the byte kernel, which a view one
    byte in takes, keeps its rows exact over every step of a sample of its
    threads."""
    n_v, tau = KRON22
    rng = np.random.default_rng(22)
    masks, alphas = _inputs(rng, n_v, tau)
    alphas[rng.random(n_v) < 0.3] = 0  # empty slice sets, as on a level
    assert _path(tau, 0, 0) == "items" and _path(tau, 1, 0) == "bytes"
    got, hits, blocks = _items_model(masks, alphas, H100_WAVE)
    assert (hits == 1).all() and blocks == H100_WAVE
    for want in _refs(masks, alphas, interpret=False):
        _eq(got, want)
    del got
    _, hits, blocks = _items_model(masks, alphas, 7, values=False)
    assert (hits == 1).all() and blocks == 7
    total = n_v * tau
    stride = _byte_stride(total)
    sample = np.random.default_rng(1).choice(stride, 4096, replace=False)
    steps = 0
    for i, row in _byte_rows(total, tau, np.sort(sample)):
        steps += 1
        assert (row < n_v).all()
    assert steps == -(-total // stride)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

@given_seeds(CASES)
def test_item_arithmetic_matches_references(seed):
    """The item kernel on seeded bytes of any value, tau a multiple of 16
    (a shift for 16-128, a division for 48, 80 and 256), ragged N_v: equal
    to both packages' references and the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(seed)
    tau = (16, 32, 48, 64, 80, 128, 256)[seed % 7]
    n_v = int(rng.integers(1, 300))
    masks, alphas = _inputs(rng, n_v, tau)
    if seed % 4 == 0:
        alphas[:] = 0
    got, hits, path = _model(masks, alphas)
    assert path == "items" and (hits == 1).all()
    for want in _refs(masks, alphas):
        _eq(got, want)


@given_seeds(CASES)
def test_byte_kernel_matches_references(seed):
    """The byte kernel (tau in {1, 2, 4} and odd taus, or views) on any
    bytes: equal to both packages' references."""
    rng = np.random.default_rng(1000 + seed)
    tau = (1, 2, 4, 3, 7, 128)[seed % 6]
    n_v = int(rng.integers(1, 3000))
    masks, alphas = _inputs(rng, n_v, tau)
    got, hits, path = _model(masks, alphas, masks_off=1)
    assert path == "bytes" and (hits == 1).all()
    for want in _refs(masks, alphas, interpret=False):
        _eq(got, want)


@pytest.mark.parametrize("total,tau", [
    (1, 1), (5, 5), (540_673, 1), (1_081_345, 3), (2_000_000, 7),
    (3_000_000, 128), (540_672 * 3, 540_673)])
def test_byte_kernel_rows_stay_exact(total, tau):
    """The byte kernel's (row, column), advanced by the stride without a
    division, equal i // tau and i % tau at every step, where the stride
    is smaller or larger than tau and the loop wraps a column."""
    stride = _byte_stride(total)
    sample = np.arange(0, stride, 997)
    seen = 0
    for i, _ in _byte_rows(total, tau, sample):
        seen += len(i)
    assert seen == sum(len(range(s, total, stride)) for s in sample)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_wrapper_takes_cuda_tensors_only():
    """The kernel wrapper refuses CPU tensors before any build or launch
    (ops sends those to the plain version), and masks beyond the 32-bit
    item index, whatever their device."""
    ops.reset_launch_counts()
    m = torch.zeros((8, 128), dtype=torch.uint8)
    a = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pull.pull_ss(m, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pull.pull_ss(m[1:], a[1:])
    big = torch.empty((2**27, 256), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="16-byte items"):
        t_pull.pull_ss(big, torch.empty(2**27, dtype=torch.uint8,
                                        device="meta"))
    assert t_pull.pull_ss.launches == 0


@pytest.mark.parametrize("tau", (1, 2, 4, 16, 128))
def test_ops_pull_ss_is_the_plain_version_on_cpu(tau):
    """On CPU tensors ``ops.pull_ss`` is ``pull_ss_ref`` (any bytes, all-zero
    alphas too) and launches nothing."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(tau)
    masks, alphas = _inputs(rng, 45, tau)
    m, a = torch.from_numpy(masks), torch.from_numpy(alphas)
    _eq(ops.pull_ss(m, a), t_ref.pull_ss_ref(m, a))
    z = torch.zeros_like(a)
    _eq(ops.pull_ss(m, z), torch.zeros_like(m))
    assert ops.launch_counts()["pull_ss"] == 0
