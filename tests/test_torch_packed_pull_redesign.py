"""The redesigned packed multi-source pull of the PyTorch port, on the CPU.

``pull_ms_packed`` (kernel 5) and ``pull_ms_packed_queued`` (kernel 9) are
the dense and the queued instance of one CUDA template,
``csrc/ms_pull.cuh``; it runs only on a GPU, where chip_smoke.py holds both
against their plain versions.  What of it runs here:

- a model of its run and item map, on the launch geometry that the header
  states (its constexprs, read from the file): a block per run of VSSs,
  items of four output words (of one slot, of 4 / kw slots, or stepped
  word by word), a thread's position stepped, never divided;
  every output word is written exactly once and every run's output starts
  16-byte aligned, over tau in {1, 2, 4, 128}, kw in {1, 2, 3, 8} and
  ragged VSS counts;
- the geometry at kron-22's and road-20's shapes: blocks, shared memory;
- a numpy model of the kernel on u32 words (ids and parents, the run's
  tiles and sigma-masked mask rows in "shared memory", then the items),
  equal to the port's plain versions and to ``repro``'s references from the
  same seeded inputs: sigma in {2, 4, 8}, zero masks, bits above sigma,
  queued buckets with repeated ids, of one id, and of padding alone.

Outputs are bits: equality is exact (tolerance 0).
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
from repro.kernels import pull_ms_packed as j_pmp  # noqa: E402
from repro.kernels import pull_ms_packed_queued as j_pq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pull_ms_packed as t_pmp  # noqa: E402
from repro_torch.kernels import pull_ms_packed_queued as t_pq  # noqa: E402

CASES = 16
TAUS = (1, 2, 4, 128)
KWS = (1, 2, 3, 8)
J_DENSE = jax.jit(j_pmp.pull_ms_packed_ref, static_argnames="sigma")
J_QUEUED = jax.jit(j_pq.pull_ms_packed_queued_ref, static_argnames="sigma")

_HEADER = (pathlib.Path(t_pmp.__file__).parent / "csrc"
           / "ms_pull.cuh").read_text()
# csrc/ms_pull.cuh's numeric constexprs (kPackedThreads, kPackedWords, ...)
_CU = {name: int(np.prod([int(x) for x in expr.split("*")]))
       for name, expr in re.findall(r"constexpr int (\w+) = ([\d *]+);",
                                    _HEADER)}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the launch geometry and the item map
# ---------------------------------------------------------------------------

def _align(tau, kw):
    """VSSs a run is a multiple of, so that its output is 16-byte
    aligned."""
    per_vss = tau * kw
    return 1 if per_vss % 4 == 0 else 2 if per_vss % 2 == 0 else 4


def _vpb(n_q, tau, sigma, kw):
    """packed_vss_per_block of csrc/ms_pull.cuh, on its constants."""
    align = _align(tau, kw)
    runs = _CU["kPackedWords"] // (tau * kw)
    fit = _CU["kPackedSmem"] // (4 * sigma * kw + tau + 8)
    share = -(-n_q // (_CU["kPackedMinBlocks"] * align)) * align
    vpb = min(runs, fit, share)
    if vpb >= align:
        vpb -= vpb % align
    return max(vpb, 1)


def _full(tau, sigma, kw):
    """The run a block takes on a large grid."""
    return _vpb(2**31 - 1, tau, sigma, kw)


def _smem(vpb, tau, sigma, kw):
    """The launcher's dynamic shared memory: tiles and mask rows, each
    16-byte rounded, then the run's ids and parents."""
    return (-(-vpb * sigma * kw * 4 // 16) * 16 + -(-vpb * tau // 16) * 16
            + 8 * vpb)


def _items(nv, tau, kw):
    """The item map of one run of ``nv`` VSSs, as the kernel's threads step
    it: per step of the threads' loop, (k, v, j, w, live), arrays over the
    threads (and the item's four words), k the item's first word in the
    run.  Where kw % 4 == 0 an item is four words of one slot (kQuad);
    where kw is 1 or 2 and tau a multiple of 4 / kw, the words of 4 / kw
    slots of one VSS (kSlots); else its words are stepped one at a time,
    across slots and VSSs (kWords).  Checks that every stepped position
    equals the divided one."""
    nt = _CU["kPackedThreads"]
    t = np.arange(nt)
    words = nv * tau * kw
    e = np.arange(4)
    if kw % 4 == 0:
        groups = kw // 4
        per_vss = tau * groups
        g, j, v = t % groups, t // groups % tau, t // per_vss
        dg, dj, dv = nt % groups, nt // groups % tau, nt // per_vss
        for it0 in range(0, nv * per_vss, nt):
            it = it0 + t
            assert ((v * tau + j) * groups + g == it).all()
            yield (4 * it, np.repeat(v[:, None], 4, 1),
                   np.repeat(j[:, None], 4, 1), 4 * g[:, None] + e,
                   (it < nv * per_vss)[:, None] & (e < 4))
            g = g + dg
            j = np.where(g >= groups, j + 1, j)
            g = np.where(g >= groups, g - groups, g)
            j = j + dj
            v = np.where(j >= tau, v + 1, v)
            j = np.where(j >= tau, j - tau, j)
            v = v + dv
        return
    if kw <= 2 and tau % (4 // kw) == 0:
        per = 4 // kw  # slots an item
        items = tau // per
        j, v = t % items * per, t // items
        dj, dv = nt % items * per, nt // items
        for it0 in range(0, nv * items, nt):
            it = it0 + t
            assert (v * items + j // per == it).all()
            yield (4 * it, np.repeat(v[:, None], 4, 1),
                   j[:, None] + e // kw, np.broadcast_to(e % kw, (nt, 4)),
                   (it < nv * items)[:, None] & (e < 4))
            j = j + dj
            v = np.where(j >= tau, v + 1, v)
            j = np.where(j >= tau, j - tau, j)
            v = v + dv
        return
    step = 4 * nt
    k = 4 * t
    w, j, v = k % kw, k // kw % tau, k // (kw * tau)
    dw, dj, dv = step % kw, step // kw % tau, step // (kw * tau)
    for k0 in range(0, words, step):
        k = k0 + 4 * t
        assert ((v * tau + j) * kw + w == k).all()
        vs, js, ws = [], [], []
        vv, jj, ww = v, j, w
        for _ in range(4):  # the item's words, stepped
            vs.append(vv), js.append(jj), ws.append(ww)
            ww = ww + 1
            jj = np.where(ww == kw, jj + 1, jj)
            ww = np.where(ww == kw, 0, ww)
            vv = np.where(jj == tau, vv + 1, vv)
            jj = np.where(jj == tau, 0, jj)
        vs, js, ws = (np.stack(x, 1) for x in (vs, js, ws))
        assert ((vs * tau + js) * kw + ws == k[:, None] + e).all()
        yield k, vs, js, ws, k[:, None] + e < words
        w = w + dw
        j = np.where(w >= kw, j + 1, j)
        w = np.where(w >= kw, w - kw, w)
        j = j + dj
        v = np.where(j >= tau, v + 1, v)
        j = np.where(j >= tau, j - tau, j)
        v = v + dv


def _cover(n_q, tau, kw, vpb):
    """How often the pull writes each output word: a block per run of vpb
    VSSs, its items as :func:`_items` steps them.  Also returns whether
    every run's output starts 16-byte aligned and how many items are
    stored word by word (partial: past the output's end)."""
    hits = np.zeros(n_q * tau * kw, np.int64)
    aligned, partial = True, 0
    for i0 in range(0, n_q, vpb):
        nv = min(vpb, n_q - i0)
        base = i0 * tau * kw
        aligned &= base % 4 == 0
        for k, _, _, _, live in _items(nv, tau, kw):
            np.add.at(hits, (base + k[:, None] + np.arange(4))[live], 1)
            partial += int((live.any(1) & ~live.all(1)).sum())
    return hits, aligned, partial


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("kw", KWS)
def test_item_map_covers_every_word_once(tau, kw):
    """At sigma 8 and 2, over one VSS, a few, and a ragged single, ragged
    last and whole full runs, with the run the launcher picks for that
    count and with the full run: every output word is written exactly
    once, every run's output starts 16-byte aligned, and only the output's
    last item can be partial; a full run's shared memory fits the 48 KB a
    block gets without opting in."""
    for sigma in (8, 2):
        full = _full(tau, sigma, kw)
        assert full % _align(tau, kw) == 0
        assert full * tau * kw <= _CU["kPackedWords"]
        assert _smem(full, tau, sigma, kw) <= 48 * 1024
        for n_q in sorted({1, 3, full - 1, full + 1, 2 * full} - {0}):
            vpb = _vpb(n_q, tau, sigma, kw)
            assert vpb % _align(tau, kw) == 0 and vpb <= full
            for run in {vpb, full}:
                hits, aligned, partial = _cover(n_q, tau, kw, run)
                assert (hits == 1).all(), (n_q, run, np.unique(hits))
                assert aligned
                assert partial == (1 if n_q * tau * kw % 4 else 0)


def test_runs_shorten_to_fill_the_card():
    """A grid of fewer than kPackedMinBlocks full runs takes shorter runs
    (never below one VSS, always 16-byte aligned), so that it has at least
    half that many blocks unless its runs are one aligned unit; a larger
    grid takes the full run."""
    blocks = _CU["kPackedMinBlocks"]
    for tau in TAUS:
        for kw in KWS:
            full, align = _full(tau, 8, kw), _align(tau, kw)
            for n_q in (1, blocks, blocks * align + 1, blocks * full,
                        blocks * full + 1):
                vpb = _vpb(n_q, tau, 8, kw)
                assert 1 <= vpb <= full and vpb % align == 0
                if n_q >= blocks * full:
                    assert vpb == full
                else:
                    assert vpb == align or 2 * -(-n_q // vpb) >= blocks


def test_item_paths_at_tau_128():
    """At the production (sigma, tau) = (8, 128): kw = 8 takes four words
    of one slot, kw = 1 and 2 four and two whole slots, kw = 3 the stepped
    words, where an item crosses a slot; a full run covers kPackedWords
    words, less the remainder."""
    assert _CU["kPackedThreads"] % 32 == 0
    for kw, slots in ((1, 4), (2, 2), (3, 2)):
        _, vs, js, _, live = next(_items(_full(128, 8, kw), 128, kw))
        spans = [len(set(zip(vs[i], js[i]))) for i in range(4)]
        assert spans[0] == slots and live[0].all()
    for kw in KWS:
        assert _full(128, 8, kw) * 128 * kw == _CU["kPackedWords"] - (
            _CU["kPackedWords"] % (128 * kw))


def test_geometry_at_production_shapes():
    """kron-22 (tau = 128, sigma = 8, kw = 8): kernel 5 over N_v = 806,384
    and kernel 9 over a bucket of 262,144 take 8 VSSs a block (100,798 and
    32,768 blocks, 3,136 bytes of shared memory); road-20 (kw = 1):
    kernel 5 over N_v = 131,080 (with the pad rows) 64 a block (2,049
    blocks, 10,752 bytes), kernel 9 over its bucket of 16,384 ids 16
    (1,024 blocks); a VSS whose tile passes kPackedSmem still gets a run
    of one."""
    assert _vpb(806_384, 128, 8, 8) == _vpb(262_144, 128, 8, 8) == 8
    assert -(-806_384 // 8) == 100_798 and 262_144 // 8 == 32_768
    assert _smem(8, 128, 8, 8) == 8 * 256 + 8 * 128 + 64
    assert _vpb(131_080, 128, 8, 1) == 64 and -(-131_080 // 64) == 2_049
    assert _smem(64, 128, 8, 1) == 64 * 32 + 64 * 128 + 512
    assert _vpb(16_384, 128, 8, 1) == 16 and 16_384 // 16 == 1_024
    assert _full(128, 8, 2048) == 1


# ---------------------------------------------------------------------------
# the kernel's values, modelled on u32 words
# ---------------------------------------------------------------------------

def _kernel_model(masks, f, v2r, qids, sigma, full=None):
    """The template on numpy u32 words: per run, the ids and parents, the
    parents' tiles and the sigma-masked mask rows ("shared memory"), then
    each item's words as the OR of the tile rows of its slot's set bits.
    ``qids`` None is the dense instance (the first len(v2r) VSSs).  The
    runs are the launcher's, or ``full`` VSSs long (a large grid's)."""
    tau, (_, _, kw) = masks.shape[1], f.shape
    n_q = len(v2r) if qids is None else len(qids)
    vpb = _vpb(n_q, tau, sigma, kw) if full is None else full
    out = np.full(n_q * tau * kw, 0xDEADBEEF, np.uint32)  # torch.empty
    for i0 in range(0, n_q, vpb):
        nv = min(vpb, n_q - i0)
        ids = np.arange(i0, i0 + nv) if qids is None else qids[i0:i0 + nv]
        tiles = f[v2r[ids]]                              # (nv, sigma, kw)
        m_s = masks[ids] & np.uint8((1 << sigma) - 1)    # (nv, tau)
        for k, v, j, w, live in _items(nv, tau, kw):
            vl, jl, wl = v[live], j[live], w[live]
            m = m_s[vl, jl]
            acc = np.zeros(vl.shape, np.uint32)
            for b in range(sigma):
                acc |= np.where((m >> b) & 1, tiles[vl, b, wl], 0).astype(
                    np.uint32)
            out[(i0 * tau * kw + k[:, None] + np.arange(4))[live]] = acc
    return out.reshape(n_q, tau, kw)


def _inputs(rng, sigma, tau, kw):
    """Seeded masks (zero rows, bits above sigma), frontier words (some
    tiles zero) and parents over a small VSS count whose last row is the
    pad VSS (zero mask)."""
    n_v = int(rng.integers(1, 3 * _full(tau, sigma, kw) + 2))
    s = int(rng.integers(1, 12))
    masks = rng.integers(0, 256, (n_v, tau)).astype(np.uint8)
    masks[rng.random(n_v) < 0.3] = 0
    masks[-1] = 0
    f = rng.integers(0, 1 << 32, (s, sigma, kw), dtype=np.uint64).astype(
        np.uint32)
    f[rng.random(s) < 0.3] = 0
    v2r = rng.integers(0, s, n_v).astype(np.int32)
    return masks, f, v2r


def _as_t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else a.dtype))


@given_seeds(CASES)
def test_dense_model_matches_references(seed):
    """Kernel 5's model equals the port's plain version and repro's
    reference, bit for bit."""
    rng = np.random.default_rng(seed)
    sigma = (2, 4, 8)[seed % 3]
    tau, kw = TAUS[seed // 3 % 4], KWS[seed // 12 % 4]
    masks, f, v2r = _inputs(rng, sigma, tau, kw)
    want = ops.pull_ms_packed(_as_t(masks), _as_t(f), _as_t(v2r),
                              sigma=sigma)
    for full in (None, _full(tau, sigma, kw)):
        got = _kernel_model(masks, f, v2r, None, sigma, full)
        _eq(got.view(np.int32), want)
    _eq(got, J_DENSE(jnp.asarray(masks), jnp.asarray(f[v2r]), sigma=sigma))


def _bucket(rng, n_v, kind):
    """qids of kind: repeated ids, one id, padding alone (the pad VSS is
    the last row), or some ids then padding."""
    pad = n_v - 1
    if kind == "repeated":
        return rng.integers(0, n_v, int(rng.integers(2, 3 * n_v + 2))
                            ).astype(np.int32)
    if kind == "one":
        return np.array([rng.integers(n_v)], np.int32)
    if kind == "padding":
        return np.full(int(rng.integers(1, 70)), pad, np.int32)
    ids = rng.choice(n_v, int(rng.integers(0, n_v + 1)), replace=False)
    q = np.full(max(8, 1 << int(len(ids)).bit_length()), pad, np.int32)
    q[: len(ids)] = np.sort(ids)
    return q


@given_seeds(CASES)
def test_queued_model_matches_references(seed):
    """Kernel 9's model over a bucket of each kind equals the port's plain
    version and repro's reference, bit for bit; padding marks nothing."""
    rng = np.random.default_rng(seed)
    sigma = (2, 4, 8)[seed % 3]
    tau, kw = TAUS[seed // 3 % 4], KWS[seed // 12 % 4]
    masks, f, v2r = _inputs(rng, sigma, tau, kw)
    for kind in ("repeated", "one", "padding", "some"):
        qids = _bucket(rng, len(v2r), kind)
        got = _kernel_model(masks, f, v2r, qids, sigma, _full(tau, sigma, kw))
        _eq(got, _kernel_model(masks, f, v2r, qids, sigma))
        want = ops.pull_ms_packed_queued(_as_t(masks), _as_t(f), _as_t(v2r),
                                         _as_t(qids), sigma=sigma)
        _eq(got.view(np.int32), want)
        _eq(got.view(np.int32), t_pq.pull_ms_packed_queued_ref(
            _as_t(masks), _as_t(f), _as_t(v2r), _as_t(qids), sigma))
        _eq(got, J_QUEUED(jnp.asarray(masks), jnp.asarray(f),
                          jnp.asarray(v2r), jnp.asarray(qids), sigma=sigma))
        if kind == "padding":
            assert not got.any()


def test_model_drops_mask_bits_above_sigma():
    """A mask byte 0xFF at sigma = 2 pulls planes 0 and 1 only: the run's
    mask rows are ANDed with the sigma bits, as the references do."""
    masks = np.full((1, 4), 0xFF, np.uint8)
    f = np.zeros((1, 2, 1), np.uint32)
    f[0, :, 0] = (1, 2)
    got = _kernel_model(masks, f, np.zeros(1, np.int32), None, 2)
    assert (got == 3).all()
    _eq(got.view(np.int32), t_pmp.pull_ms_packed_ref(
        _as_t(masks), _as_t(f), sigma=2))
