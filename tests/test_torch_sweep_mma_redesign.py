"""The redesigned frontier_sweep (kernel 3) and pull_mma_ms_packed (kernel 7)
of the PyTorch port, on the CPU.

Both kernels run only on a GPU, where chip_smoke.py holds them against their
plain versions.  What of them runs here:

- a numpy model of ``frontier_sweep``'s thread map on the geometry that
  ``csrc/blest_ss.cu`` states (its constexprs, read from the file): a
  thread per item of 16 vertices (16 / sigma whole slice sets), the tail's
  sets on the thread after the last item, and every set on the per-vertex
  kernel where a pointer is off the alignment its vector accesses need.
  Every vertex, set and output byte is written exactly once, for n in
  {sigma, 16, 17 sigma, ragged, road-20's n_ext}, from aligned tensors and
  from a view one byte in; the model's byte arithmetic equals the port's
  and ``repro``'s references on any bytes, not only 0/1;
- a model of kernel 7's plane-row form (``csrc/ms_pull.cuh`` with
  ``kPlanes``): the loader's 16-byte loads of 16 / sigma plane rows, each
  row's positive-weight byte (``blest::positive_bits``'s multiply) and
  negative flag, every slot loaded once; then the selective OR over the
  positive weights, or the exact count where a row has a negative weight;
  and its run geometry at kron-22's and road-20's shapes;
- a model of kernel 7's tensor-core form (``csrc/blest_ms.cu``'s
  ``pull_mma_bmma_kernel``): the block-diagonal K packing of 128 / sigma
  VSSs (each slot row's positive bits in its VSS's segment), the bit
  transpose of the tiles into B columns in the fragment's order, the
  ``m8n8k128`` fragments (A row = groupID, K word = thread in group; D
  columns 2 t, 2 t + 1), 4, 2 or 1 frontier words a step as kw allows, the
  counts > 0 placed into words and ORed across a row's four threads, the
  stores; every output word once, and the
  ``mma.sync`` count ``chip_smoke.bmma_count`` reports;
- both models equal ``repro``'s ``pull_mma_ms_packed_ref`` and the port's
  plain version on 0/1 planes and on random int8 planes (negative
  weights), at sigma in {2, 4, 8} and kw in {1, 2, 3, 8}.

Outputs are bytes, int32 levels and bits: equality is exact (tolerance 0).
"""
from __future__ import annotations

import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypothesis_shim import given_seeds  # noqa: E402
from repro.kernels import pull_mma_ms_packed as j_mma  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pull_mma_ms_packed as t_mma  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = pathlib.Path(t_mma.__file__).parent / "csrc"
CASES = 12
SIGMAS = (2, 4, 8)
KWS = (1, 2, 3, 8)
J_SWEEP = jax.jit(j_ref.frontier_sweep_ref, static_argnames="sigma")
J_MMA = jax.jit(j_mma.pull_mma_ms_packed_ref)


def _constexprs(name):
    """The numeric constexprs of a CUDA source (``kThreads = 256``,
    ``kMaxBlocks = 132 * 16``, ...)."""
    text = (CSRC / name).read_text()
    return {k: int(np.prod([int(x) for x in expr.split("*")]))
            for k, expr in re.findall(r"constexpr (?:int|int64_t) (\w+) = "
                                      r"([\d *]+);", text)}


SS = _constexprs("blest_ss.cu")
PULL = _constexprs("ms_pull.cuh")
MS = _constexprs("blest_ms.cu")


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# frontier_sweep: the thread map and the arithmetic
# ---------------------------------------------------------------------------

def _sweep_bytes(cur, nxt, lv, ell, sigma):
    """The kernel's per-vertex arithmetic on (m, k * sigma) byte blocks:
    uint8 diff, the level, the int32 sum of a set's diffs, its low byte and
    whether it is nonzero."""
    c = cur.astype(np.uint32)
    x = nxt.astype(np.uint32)
    diff = x & ((np.uint32(1) - c) & np.uint32(0xFF))
    lv_out = np.where(diff != 0, np.int32(ell), lv)
    shifts = np.arange(sigma, dtype=np.uint32)
    m, k = diff.shape
    word = (diff.reshape(m, k // sigma, sigma) << shifts).sum(
        axis=2, dtype=np.uint32)
    return lv_out, (word & 0xFF).astype(np.uint8), (word != 0).astype(
        np.uint8)


def _sweep_model(v_curr, v_next, level, ell, sigma, offsets=(0,) * 5):
    """frontier_sweep as the launcher and kernels of csrc/blest_ss.cu run
    it, with the byte offsets of (v_curr, v_next, level, v_out, level_out)
    from a 16-byte boundary (the outputs are fresh, at 0).  Returns the
    four outputs, how often each vertex and set was written, the path and
    the blocks."""
    n = len(v_curr)
    num_sets = n // sigma
    item = SS["kSweepItem"]
    k_sets = item // sigma
    v_out = np.full(n, 0xAB, np.uint8)
    level_out = np.full(n, -7, np.int32)
    f_words = np.full(num_sets, 0xCD, np.uint8)
    active = np.full(num_sets, 0xEF, np.uint8)
    hits_v = np.zeros(n, np.int64)
    hits_s = np.zeros(num_sets, np.int64)

    def sets(s):  # the per-vertex path over the slice sets s
        u = (s[:, None] * sigma + np.arange(sigma)).reshape(-1)
        lv, fw, act = _sweep_bytes(v_curr[u].reshape(len(s), sigma),
                                   v_next[u].reshape(len(s), sigma),
                                   level[u].reshape(len(s), sigma), ell,
                                   sigma)
        v_out[u] = v_next[u]
        level_out[u] = lv.reshape(-1)
        f_words[s], active[s] = fw[:, 0], act[:, 0]
        np.add.at(hits_v, u, 1)
        np.add.at(hits_s, s, 1)

    if any(off % 16 for off in offsets):
        threads = SS["kThreads"]
        blocks = min(-(-num_sets // threads), SS["kMaxBlocks"])
        stride = blocks * threads
        for s0 in range(0, num_sets, stride):  # the grid-stride loop
            sets(np.arange(s0, min(s0 + stride, num_sets)))
        return (v_out, level_out, f_words, active), hits_v, hits_s, \
            "sets", blocks
    items = n // item
    tail = items * item < n
    blocks = -(-(items + tail) // SS["kSweepThreads"])
    i = np.arange(blocks * SS["kSweepThreads"])  # one thread per index
    mine = i[i < items]
    u = (mine[:, None] * item + np.arange(item)).reshape(-1)
    lv, fw, act = _sweep_bytes(v_curr[u].reshape(len(mine), item),
                               v_next[u].reshape(len(mine), item),
                               level[u].reshape(len(mine), item), ell, sigma)
    v_out[u] = v_next[u]
    level_out[u] = lv.reshape(-1)
    s = (mine[:, None] * k_sets + np.arange(k_sets)).reshape(-1)
    f_words[s], active[s] = fw.reshape(-1), act.reshape(-1)
    np.add.at(hits_v, u, 1)
    np.add.at(hits_s, s, 1)
    if (i == items).any():  # the tail's thread
        sets(np.arange(items * k_sets, num_sets))
    return (v_out, level_out, f_words, active), hits_v, hits_s, "items", \
        blocks


def _sweep_inputs(rng, n, any_bytes):
    hi = 256 if any_bytes else 2
    v_curr = rng.integers(0, hi, n).astype(np.uint8)
    v_next = rng.integers(0, hi, n).astype(np.uint8)
    if not any_bytes:
        v_next |= v_curr
    level = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return v_curr, v_next, level, int(rng.integers(-2**31, 2**31))


def _sweep_refs(v_curr, v_next, level, ell, sigma):
    t = ops.frontier_sweep(*(torch.from_numpy(x) for x in
                             (v_curr, v_next, level)), ell, sigma=sigma)
    j = J_SWEEP(jnp.asarray(v_curr), jnp.asarray(v_next), jnp.asarray(level),
                jnp.int32(ell), sigma=sigma)
    return t, j


ROAD_N_EXT = 1024 * 1024 + 8  # grid2d(1024, 1024) at sigma = 8


SWEEP_SIZES = [(sigma, kind) for sigma in (1, 2, 4, 8)
               for kind in ("sigma", "16", "17sigma", "ragged")] + [
                   (8, "road-20")]


@pytest.mark.parametrize("sigma,kind", SWEEP_SIZES)
def test_sweep_writes_everything_once(sigma, kind):
    """From aligned tensors (the 16-byte items and the tail's thread), from
    views one byte in and a level view one element in (the per-vertex
    kernel): every vertex, slice set and output byte is written exactly
    once, and the outputs equal both packages' references, on any bytes."""
    n = {"sigma": sigma, "16": 16, "17sigma": 17 * sigma,
         "ragged": sigma * 37, "road-20": ROAD_N_EXT}[kind]
    rng = np.random.default_rng(n * 10 + sigma)
    args = _sweep_inputs(rng, n, any_bytes=True)
    t, j = _sweep_refs(*args, sigma)
    paths = set()
    for offsets in ((0, 0, 0, 0, 0), (1, 1, 4, 0, 0), (0, 0, 4, 0, 0),
                    (0, 3, 0, 0, 0)):
        got, hits_v, hits_s, path, _ = _sweep_model(*args, sigma, offsets)
        paths.add(path)
        assert (hits_v == 1).all() and (hits_s == 1).all()
        for g, tt, jj in zip(got, t, j):
            _eq(g, tt)
            _eq(g, jj)
    assert paths == {"items", "sets"}


@given_seeds(CASES)
def test_sweep_model_matches_references(seed):
    """The item path's arithmetic on seeded inputs, 0/1 bytes in even
    seeds and any bytes in odd ones, ragged n: equal to the port's plain
    version and repro's reference."""
    rng = np.random.default_rng(seed)
    sigma = (1, 2, 4, 8)[seed % 4]
    n = sigma * int(rng.integers(1, 400))
    args = _sweep_inputs(rng, n, any_bytes=seed % 2 == 1)
    got, *_ = _sweep_model(*args, sigma)
    t, j = _sweep_refs(*args, sigma)
    for g, tt, jj in zip(got, t, j):
        _eq(g, tt)
        _eq(g, jj)


def test_sweep_geometry_at_full_size():
    """16-vertex items (every sigma divides them) on 128-thread blocks:
    road-20's 1,048,584 vertices are 65,536 items and the tail's set, 513
    blocks, 3.9 on each of the H100's 132 SMs; kron-22's 4,194,312 are
    2,049 blocks."""
    assert SS["kSweepItem"] == 16 and SS["kSweepThreads"] % 32 == 0
    assert all(SS["kSweepItem"] % s == 0 for s in (1, 2, 4, 8))
    ones = np.ones(ROAD_N_EXT, np.uint8)
    _, _, _, path, blocks = _sweep_model(ones, ones,
                                         np.zeros(ROAD_N_EXT, np.int32), 1, 8)
    assert path == "items" and blocks == 513 and blocks / 132 > 3.8
    assert ROAD_N_EXT // 16 == 65_536
    assert -(-(4 * 1024 * 1024 // 16 + 1) // SS["kSweepThreads"]) == 2_049


# ---------------------------------------------------------------------------
# pull_mma_ms_packed: plane rows into positive bytes and flags
# ---------------------------------------------------------------------------

_LOW7 = np.uint64(0x7F7F7F7F7F7F7F7F)


def _positive_bits(rows):
    """blest::positive_bits on uint64 rows: byte b nonzero with its sign
    bit clear, gathered into bit b by the multiply."""
    nonzero = (((rows & _LOW7) + _LOW7) | rows) & ~_LOW7
    pos = nonzero & ~rows
    return ((pos >> np.uint64(7)) * np.uint64(0x0102040810204080)
            >> np.uint64(56)).astype(np.uint8)


def _has_negative(rows):
    return ((rows & np.uint64(0x8080808080808080)) != 0).astype(np.uint8)


def _rows64(planes):
    """(..., sigma) int8 plane rows as uint64 (weight b in byte b, bytes
    past sigma zero): blest::plane_row."""
    b = planes.view(np.uint8).astype(np.uint64)
    return (b << (np.uint64(8) * np.arange(planes.shape[-1],
                                           dtype=np.uint64))).sum(
        axis=-1, dtype=np.uint64)


def _load_run(planes_flat, sigma, aligned):
    """The plane-row loader over one run's contiguous rows (``slots * sigma``
    bytes): 16-byte loads of 16 / sigma rows where sigma divides 16 and the
    run starts aligned, each row cut from the load's two 64-bit halves;
    the rest row by row.  Returns the positive bytes, the flags and how
    often each slot was loaded."""
    slots = len(planes_flat) // sigma
    pos = np.zeros(slots, np.uint8)
    neg = np.zeros(slots, np.uint8)
    hits = np.zeros(slots, np.int64)
    first = 0
    if 16 % sigma == 0 and aligned:
        per = 16 // sigma
        nvec = slots // per
        vecs = planes_flat[: nvec * 16].view(np.uint64).reshape(nvec, 2)
        keep = np.uint64(0xFFFFFFFFFFFFFFFF if sigma == 8
                         else (1 << (8 * sigma)) - 1)
        for k in range(per):
            bit = 8 * sigma * k
            row = (vecs[:, 0] >> np.uint64(bit) if bit < 64
                   else vecs[:, 1] >> np.uint64(bit - 64)) & keep
            pos[k::per][:nvec] = _positive_bits(row)
            neg[k::per][:nvec] = _has_negative(row)
            hits[np.arange(nvec) * per + k] += 1
        first = nvec * per
    rest = planes_flat[first * sigma:].view(np.int8).reshape(-1, sigma)
    rows = _rows64(rest)
    pos[first:], neg[first:] = _positive_bits(rows), _has_negative(rows)
    hits[first:] += 1
    return pos, neg, hits


def _vpb_planes(n_q, tau, sigma, kw):
    """packed_vss_per_block of csrc/ms_pull.cuh with two mask rows a VSS
    (positive bytes and flags), on its constants."""
    per_vss = tau * kw
    align = 1 if per_vss % 4 == 0 else 2 if per_vss % 2 == 0 else 4
    runs = PULL["kPackedWords"] // per_vss
    fit = PULL["kPackedSmem"] // (4 * sigma * kw + 2 * tau + 8)
    share = -(-n_q // (PULL["kPackedMinBlocks"] * align)) * align
    vpb = min(runs, fit, share)
    if vpb >= align:
        vpb -= vpb % align
    return max(vpb, 1)


def _exact(planes, tiles):
    """count[l] = sum_b a[b] * bit_l(tile[b]) > 0, packed: the reference's
    arithmetic (blest::count_word), (n, sigma) rows on (n, sigma, kw)."""
    lanes = np.arange(32, dtype=np.uint32)
    bits = ((tiles[..., None] >> lanes) & 1).astype(np.int64)
    counts = (planes.astype(np.int64)[:, :, None, None] * bits).sum(axis=1)
    return ((counts > 0).astype(np.uint64) << lanes.astype(np.uint64)).sum(
        axis=-1, dtype=np.uint64).astype(np.uint32)


def _planes_model(a, f, v2r, aligned=True):
    """Kernel 7's plane-row instance: per run of the launcher's VSSs, the
    loader, then each slot's words, the OR of the tile rows of its
    positive bits or, flagged, the exact count."""
    n_q, tau, sigma = a.shape
    kw = f.shape[2]
    vpb = _vpb_planes(n_q, tau, sigma, kw)
    out = np.full((n_q, tau, kw), 0xDEADBEEF, np.uint32)
    for i0 in range(0, n_q, vpb):
        nv = min(vpb, n_q - i0)
        run = np.ascontiguousarray(a[i0:i0 + nv]).reshape(-1).view(np.uint8)
        pos, neg, hits = _load_run(run, sigma, aligned
                                   and (i0 * tau * sigma) % 16 == 0)
        assert (hits == 1).all()
        tiles = f[v2r[i0:i0 + nv]]                         # (nv, sigma, kw)
        t_slot = np.repeat(tiles, tau, axis=0)             # (nv*tau, ...)
        acc = np.zeros((nv * tau, kw), np.uint32)
        for b in range(sigma):
            acc |= np.where(((pos >> b) & 1)[:, None] == 1, t_slot[:, b], 0
                            ).astype(np.uint32)
        flagged = neg == 1
        if flagged.any():
            acc[flagged] = _exact(a[i0:i0 + nv].reshape(-1, sigma)[flagged],
                                  t_slot[flagged])
        out[i0:i0 + nv] = acc.reshape(nv, tau, kw)
    return out


def _mma_inputs(rng, sigma, tau, kw, int8):
    n_q = int(rng.integers(1, 70)) * 8
    s = int(rng.integers(1, 12))
    if int8:
        a = rng.integers(-128, 128, (n_q, tau, sigma)).astype(np.int8)
        sel = rng.random(n_q) < 0.3  # some VSSs without a negative weight
        a[sel] = (np.abs(a[sel].astype(np.int16)) // 2).astype(np.int8)
    else:
        a = rng.integers(0, 2, (n_q, tau, sigma)).astype(np.int8)
        a[rng.random(n_q) < 0.2] = 0
    f = rng.integers(0, 1 << 32, (s, sigma, kw), dtype=np.uint64).astype(
        np.uint32)
    f[rng.random(s) < 0.2] = 0
    v2r = rng.integers(0, s, n_q).astype(np.int32)
    return a, f, v2r


def _mma_refs(a, f, v2r):
    tiles = f[v2r]
    want = np.asarray(J_MMA(jnp.asarray(a), jnp.asarray(tiles)))
    port = ops.pull_mma_ms_packed(torch.from_numpy(a),
                                  torch.from_numpy(f.view(np.int32)),
                                  torch.from_numpy(v2r))
    _eq(port, want.view(np.int32))
    return want


@pytest.mark.parametrize("sigma", SIGMAS + (1,))
def test_plane_loader_matches_rows(sigma):
    """The loader's positive bytes and flags equal positive_bits and
    has_negative of each row, every slot loaded once, whether its runs
    start 16-byte aligned or not; positive_bits is bit b where weight b is
    > 0."""
    rng = np.random.default_rng(sigma)
    planes = rng.integers(-128, 128, (37, sigma)).astype(np.int8)
    planes[::5] = 0
    for aligned in (True, False):
        pos, neg, hits = _load_run(planes.reshape(-1).view(np.uint8), sigma,
                                   aligned)
        assert (hits == 1).all()
        want = ((planes > 0).astype(np.uint8)
                << np.arange(sigma, dtype=np.uint8)).sum(axis=1,
                                                         dtype=np.uint8)
        _eq(pos, want)
        _eq(neg, (planes < 0).any(axis=1))


def test_planes_geometry_at_production_shapes():
    """The plane-row instance keeps two (vpb, tau) byte arrays: at kron-22
    (806,384 VSSs, tau = 128, kw = 8) still 8 VSSs a block, 100,798 blocks,
    4,160 bytes of shared memory; at road-20 (131,080, kw = 1) 64 a block;
    the mask instances' runs are unchanged at those shapes."""
    assert _vpb_planes(806_384, 128, 8, 8) == 8
    assert -(-806_384 // 8) == 100_798
    tiles, rows = 8 * 8 * 8 * 4, 8 * 128
    assert tiles + 2 * rows + 8 * 8 == 4_160
    assert _vpb_planes(131_080, 128, 8, 1) == 64
    assert (PULL["kPackedSmem"] // (4 * 8 * 8 + 128 + 8)
            >= _vpb_planes(806_384, 128, 8, 8))


@given_seeds(CASES)
def test_planes_model_matches_references(seed):
    """Kernel 7's plane-row model equals repro's reference and the port's
    plain version, on 0/1 planes (even seeds) and random int8 planes with
    negative weights (odd), sigma in {2, 4, 8}, kw in {1, 2, 3, 8}, tau in
    {1, 2, 4, 128}."""
    rng = np.random.default_rng(seed)
    sigma, kw = SIGMAS[seed % 3], KWS[seed // 3 % 4]
    tau = (1, 2, 4, 128)[seed % 4]
    a, f, v2r = _mma_inputs(rng, sigma, tau, kw, int8=seed % 2 == 1)
    want = _mma_refs(a, f, v2r)
    _eq(_planes_model(a, f, v2r), want)
    _eq(_planes_model(a, f, v2r, aligned=False), want)


# ---------------------------------------------------------------------------
# pull_mma_ms_packed: the tensor-core form
# ---------------------------------------------------------------------------

def _transpose_cols(tiles, sigma, kw):
    """Step 2 of the tensor-core form: K position p = v * sigma + b is
    tile row (v, b); the 32 ballots of task (kk, w) give lane l the K word
    kk of lane column 32 w + l, stored at cols[((w * 8 + g) * 4 + kk) * 4
    + nt] for l = 8 nt + g."""
    group = 128 // sigma
    kp = group * sigma
    flat = tiles.reshape(-1, kw)                   # (group * sigma, kw)
    cols = np.zeros(128 * kw, np.uint32)
    for w in range(kw):
        for kk in range(4):
            p = 32 * kk + np.arange(32)
            r = np.where(p < kp, flat[np.minimum(p, kp - 1), w], 0).astype(
                np.uint32)
            for lane in range(32):  # ballot l: bit i = bit l of lane i's r
                mine = ((r >> np.uint32(lane)) & 1).astype(np.uint64) \
                    << np.arange(32, dtype=np.uint64)
                g, nt = lane & 7, lane >> 3
                cols[((w * 8 + g) * 4 + kk) * 4 + nt] = np.uint32(mine.sum())
    return cols


def _bmma_model(a, f, v2r):
    """pull_mma_bmma_kernel over every group of 128 / sigma VSSs, warp by
    warp, thread (g, t) by thread; returns the marks, how often each word
    was written and the mma.sync count."""
    n_q, tau, sigma = a.shape
    kw = f.shape[2]
    group = 128 // sigma
    step = 4 if kw % 4 == 0 else 2 if kw % 2 == 0 else 1  # words a step
    vec = step == 4
    out = np.full((n_q * tau, kw), 0xDEADBEEF, np.uint32)
    hits = np.zeros((n_q * tau, kw), np.int64)
    mmas = 0
    g = np.arange(32) >> 2
    t = np.arange(32) & 3
    for q0 in range(0, n_q, group):
        nv = min(group, n_q - q0)
        slots = nv * tau
        tiles = np.zeros((group, sigma, kw), np.uint32)
        tiles[:nv] = f[v2r[q0:q0 + nv]]
        rows = a[q0:q0 + nv].reshape(-1, sigma)
        pos = _positive_bits(_rows64(rows))
        neg = _has_negative(_rows64(rows))
        cols = _transpose_cols(tiles, sigma, kw)
        for m in range(-(-slots // 8)):
            s = 8 * m + g                               # a thread's row
            live = s < slots
            seg = (np.minimum(s, slots - 1) // tau) * sigma - 32 * t
            ps = np.where(live, pos[np.minimum(s, slots - 1)], 0).astype(
                np.int64)
            afrag = np.where(seg >= 0,
                             np.where(seg < 32, ps << np.clip(seg, 0, 31), 0),
                             np.where(-seg < sigma,
                                      ps >> np.clip(-seg, 0, 31), 0))
            afrag = (afrag & 0xFFFFFFFF).astype(np.uint32)
            for w0 in range(0, kw, step):
                r = np.zeros((step, 32), np.uint32)
                for e in range(step):
                    w = w0 + e
                    b = cols[(((w * 8 + g) * 4 + t) * 4)[:, None]
                             + np.arange(4)]            # (32, nt)
                    bits = np.zeros(32, np.uint32)
                    for nt in range(4):
                        mmas += 1
                        # D[row, col] = sum over the K words of popc(A & B)
                        # of the fragments: row g of A is in threads 4g..+3,
                        # column c of B in threads 4c..+3
                        a_rows = afrag.reshape(8, 4)
                        b_cols = b[:, nt].reshape(8, 4)
                        d = np.bitwise_count(
                            a_rows[:, None, :] & b_cols[None, :, :]).sum(-1)
                        d0, d1 = d[g, 2 * t], d[g, 2 * t + 1]
                        bits |= (np.where(d0 > 0, 1, 0)
                                 | np.where(d1 > 0, 2, 0)).astype(
                            np.uint32) << np.uint32(8 * nt)
                    bits <<= (2 * t).astype(np.uint32)
                    bits |= bits[np.arange(32) ^ 1]      # __shfl_xor 1
                    bits |= bits[np.arange(32) ^ 2]      # __shfl_xor 2
                    r[e] = bits
                for lane in range(32):
                    sl = int(s[lane])
                    if sl >= slots:
                        continue
                    words = ([w0 + e for e in range(4)] if vec and t[lane] == 0
                             else [w0 + t[lane]] if not vec
                             and t[lane] < step else [])
                    for w in words:
                        e = w - w0
                        x = r[e, lane]
                        if neg[sl]:
                            x = _exact(rows[sl][None],
                                       tiles[sl // tau][None])[0, w]
                        out[q0 * tau + sl, w] = x
                        hits[q0 * tau + sl, w] += 1
    return out.reshape(n_q, tau, kw), hits, mmas


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("kw", KWS)
@pytest.mark.parametrize("int8", (False, True), ids=("planes01", "int8"))
def test_bmma_model_matches_references(sigma, kw, int8):
    """The tensor-core form's model equals repro's reference and the port's
    plain version (and the plane-row model) on 0/1 and random int8
    planes; every output word is written once; its mma.sync count is
    chip_smoke.bmma_count's."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(sigma * 100 + kw * 2 + int8)
    tau = 128 if sigma == 8 else (1, 2, 4)[kw % 3]
    a, f, v2r = _mma_inputs(rng, sigma, tau, kw, int8)
    a, v2r = a[:2 * 128 // sigma + 8], v2r[:2 * 128 // sigma + 8]
    want = _mma_refs(a, f, v2r)
    got, hits, mmas = _bmma_model(a, f, v2r)
    assert (hits == 1).all()
    _eq(got, want)
    _eq(_planes_model(a, f, v2r), want)
    assert mmas == chip_smoke.bmma_count(a.shape[0], tau, sigma, kw)


def test_bmma_geometry_at_kron22():
    """K = 128 packs 16 VSSs at sigma = 8: 50,399 blocks over kron-22's
    806,384 VSSs, 412,868,608 mma.sync at kappa = 256; a group's shared
    memory (B columns, tiles, parents, positive and flag bytes) is 12,352
    bytes, under the 48 KB a block gets without opting in."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    assert MS["kBmmaThreads"] == 256
    assert -(-806_384 // 16) == 50_399
    assert chip_smoke.bmma_count(806_384, 128, 8, 8) == 412_868_608
    smem = 4 * (128 * 8 + 16 * 8 * 8 + 16) + -(-2 * 16 * 128 // 16) * 16
    assert smem == 12_352 and smem <= 48 * 1024


def test_bmma_wrapper_on_cpu_is_the_plain_version():
    """pull_mma_ms_packed_bmma sends CPU tensors to the plain version
    (launching nothing) and refuses a VSS count off the block, as the
    launched form's path does."""
    rng = np.random.default_rng(5)
    a, f, v2r = _mma_inputs(rng, 8, 4, 2, int8=True)
    before = t_mma.pull_mma_ms_packed_bmma.launches
    got = t_mma.pull_mma_ms_packed_bmma(
        torch.from_numpy(a), torch.from_numpy(f.view(np.int32)),
        torch.from_numpy(v2r))
    _eq(got, _mma_refs(a, f, v2r).view(np.int32))
    assert t_mma.pull_mma_ms_packed_bmma.launches == before
    with pytest.raises(ValueError, match="pad-and-mask"):
        t_mma.pull_mma_ms_packed_bmma(
            torch.from_numpy(a[1:]), torch.from_numpy(f.view(np.int32)),
            torch.from_numpy(v2r[1:]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_mma.pull_mma_ms_packed(torch.from_numpy(a),
                                 torch.from_numpy(f.view(np.int32)),
                                 torch.from_numpy(v2r))


def test_sweep_wrapper_keeps_its_contract_on_cpu():
    """The wrapper's contract is unchanged: CUDA tensors only (ops sends CPU
    tensors to the plain version), sigma in {1, 2, 4, 8} dividing n."""
    from repro_torch.kernels import frontier_sweep as t_sweep
    x = torch.zeros(16, dtype=torch.uint8)
    lv = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_sweep.frontier_sweep(x, x, lv, 1, sigma=8)
    out = ops.frontier_sweep(x, x + 1, lv, 3, sigma=8)
    _eq(out[1], np.full(16, 3, np.int32))
    _eq(out[2], np.full(2, 255, np.uint8))
    _eq(t_ref.frontier_sweep_ref(x, x + 1, lv, 3, sigma=8)[3], np.ones(2))
