"""Multi-source kernel modules of the PyTorch port against the JAX package's.

On CPU tensors ``repro_torch.kernels.ops`` runs the plain PyTorch versions
of ``pull_ms``, ``pull_ms_packed``, ``scatter_or`` and ``pull_mma_ms_packed``;
they must equal ``repro``'s jnp references on the same numpy inputs over
random tiny graphs (ragged n, isolated vertices, empty frontiers), and, at a
few tiny shapes, the Pallas kernels in interpret mode (not ``pull_ms``,
whose interpret mode crashes in XLA's CPU compiler).  The MMA tile prep must
equal ``repro``'s on a misaligned n.  Outputs are bits and integer counts:
equality is exact (tolerance 0).  The CUDA kernels themselves run only on a
GPU; chip_smoke.py holds them against these plain versions there.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypothesis_shim import given_seeds  # noqa: E402
from repro.core import blest as j_blest  # noqa: E402
from repro.core.bvss import build_bvss as j_build  # noqa: E402
from repro.core.graph import from_edges as j_from_edges  # noqa: E402
from repro.kernels import pull_mma_ms_packed as j_mma  # noqa: E402
from repro.kernels import pull_ms_packed as j_pmp  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels import scatter_or as j_so  # noqa: E402
from repro_torch.core import blest  # noqa: E402
from repro_torch.core.bvss import BvssConfig, build_bvss  # noqa: E402
from repro_torch.core.graph import Graph, from_edges  # noqa: E402
from repro_torch.core.msbfs import frontier_planes  # noqa: E402
from repro_torch.kernels import ops, words  # noqa: E402
from repro_torch.kernels import pull_mma_ms_packed as mma  # noqa: E402
from repro_torch.kernels import pull_ms as t_pull_ms  # noqa: E402
from repro_torch.kernels import pull_ms_packed as t_pmp  # noqa: E402
from repro_torch.kernels import scatter_or as t_so  # noqa: E402

CASES = 30
# (n, sigma, tau): the pool of tests/test_kernel_parity.py
SHAPES = ((3, 8, 1), (8, 8, 2), (12, 4, 2), (9, 2, 4), (21, 2, 1), (33, 8, 2),
          (19, 4, 4), (24, 8, 2))
KAPPAS_BYTE = (8, 32, 48)   # byteplane lanes need no word alignment
KAPPAS_PACKED = (32, 64)
MMA_BLOCKS = (8, 16)        # 16 forces the ragged-last-tile pad
# repro's references, jitted: one compile per shape instead of one per op
J_PULL_MS = jax.jit(j_ref.pull_ms_ref)
J_PULL_MS_PACKED = jax.jit(j_pmp.pull_ms_packed_ref, static_argnames="sigma")
J_SCATTER_OR = jax.jit(j_so.scatter_or_ref)
J_PULL_MMA = jax.jit(j_mma.pull_mma_ms_packed_ref)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _rand_bd(rng):
    """A random tiny graph's device BVSS (m may be 0: every vertex
    isolated)."""
    n, sigma, tau = SHAPES[int(rng.integers(len(SHAPES)))]
    m = int(rng.integers(0, 3 * n + 1))
    g = Graph(n=n, src=rng.integers(0, n, m), dst=rng.integers(0, n, m))
    return blest.to_device(build_bvss(g, BvssConfig(sigma=sigma, tau=tau)),
                           device="cpu")


def _rand_words(rng, shape, empty=0.15) -> np.ndarray:
    """Random uint32 words, all zero (an empty frontier) in ~15% of cases."""
    if rng.random() < empty:
        return np.zeros(shape, np.uint32)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _planes(bd, fv: np.ndarray) -> np.ndarray:
    return frontier_planes(bd, _t(fv)).numpy()


@given_seeds(CASES)
def test_pull_ms_matches_reference(seed):
    """Byteplane pull on 0/1 planes and, in a third of the cases, on any
    bytes (the reference takes them as signed int8)."""
    rng = np.random.default_rng(seed)
    bd = _rand_bd(rng)
    kappa = KAPPAS_BYTE[seed % len(KAPPAS_BYTE)]
    hi = 256 if seed % 3 == 0 else 2
    fv = rng.integers(0, hi, (bd.n_ext, kappa)).astype(np.uint8)
    if rng.random() < 0.15:
        fv[:] = 0
    f = _planes(bd, fv)
    out = ops.pull_ms(bd.masks, _t(f), bd.v2r, sigma=bd.sigma)
    assert out.dtype == torch.uint8
    v2r = bd.v2r.numpy()
    _eq(out, J_PULL_MS(jnp.asarray(bd.masks.numpy()),
                               jnp.asarray(f[v2r])))


@given_seeds(CASES)
def test_pull_ms_packed_matches_reference(seed):
    """Packed pull == repro's reference == the byteplane pull unpacked."""
    rng = np.random.default_rng(seed)
    bd = _rand_bd(rng)
    kappa = KAPPAS_PACKED[seed % len(KAPPAS_PACKED)]
    f = _planes(bd, _rand_words(rng, (bd.n_ext, kappa // 32)).view(np.int32))
    out = ops.pull_ms_packed(bd.masks, _t(f), bd.v2r, sigma=bd.sigma)
    assert out.dtype == torch.int32
    v2r = bd.v2r.numpy()
    _eq(_u32(out), J_PULL_MS_PACKED(
        jnp.asarray(bd.masks.numpy()), jnp.asarray(f.view(np.uint32)[v2r]),
        sigma=bd.sigma))
    bytes_ = words.unpack_words(_t(f))  # the same frontier as 0/1 planes
    _eq(words.unpack_words(out), ops.pull_ms(bd.masks, bytes_, bd.v2r,
                                             sigma=bd.sigma))


@given_seeds(CASES)
def test_scatter_or_matches_reference(seed):
    """Random rows with duplicates (the reference's int32 rows, as the
    port's int64); all-duplicate rows in a fifth of the cases (every
    element ORs into one row)."""
    rng = np.random.default_rng(seed)
    n_rows = (7, 33)[seed % 2]  # a few shapes: jax compiles each
    kw = (1, 3)[seed // 2 % 2]
    t = (16, 50)[seed // 4 % 2]
    dest = _rand_words(rng, (n_rows, kw), empty=0.3)
    rows = rng.integers(0, n_rows, t).astype(np.int32)
    if seed % 5 == 0:
        rows[:] = rows[0]
    marks = _rand_words(rng, (t, kw))
    want = np.asarray(J_SCATTER_OR(
        jnp.asarray(dest), jnp.asarray(rows), jnp.asarray(marks)))
    out = ops.scatter_or(_t(dest.view(np.int32)), _t(rows).long(),
                         _t(marks.view(np.int32)))
    assert out.dtype == torch.int32
    _eq(_u32(out), want)
    if seed % 5 == 0:
        _eq(want[rows[0]], dest[rows[0]] | np.bitwise_or.reduce(marks))


@given_seeds(CASES)
def test_pull_mma_matches_reference(seed):
    """On prepped tiles: == repro's reference == the gather pull over the
    real VSS prefix, zero on the pad tiles.  On random int8 planes (negative
    weights included): == repro's reference."""
    rng = np.random.default_rng(seed)
    bd = _rand_bd(rng)
    kappa = KAPPAS_PACKED[seed % len(KAPPAS_PACKED)]
    block = MMA_BLOCKS[(seed // 2) % len(MMA_BLOCKS)]
    tiles = mma.prep_mma_tiles(bd, block=block)
    f = _planes(bd, _rand_words(rng, (bd.n_ext, kappa // 32)).view(np.int32))
    f32 = jnp.asarray(f.view(np.uint32))
    out = ops.pull_mma_ms_packed(tiles.a_planes, _t(f), tiles.v2r,
                                 sigma=bd.sigma, block=block)
    _eq(_u32(out), J_PULL_MMA(
        jnp.asarray(tiles.a_planes.numpy()), f32[tiles.v2r.numpy()]))
    n_q = bd.num_vss_pad
    _eq(out[:n_q], ops.pull_ms_packed(bd.masks, _t(f), bd.v2r,
                                      sigma=bd.sigma))
    assert not out[n_q:].any()
    a = rng.integers(-128, 128, tiles.a_planes.shape).astype(np.int8)
    out = ops.pull_mma_ms_packed(_t(a), _t(f), tiles.v2r, sigma=bd.sigma,
                                 block=block)
    _eq(_u32(out), J_PULL_MMA(jnp.asarray(a),
                                                f32[tiles.v2r.numpy()]))


@pytest.mark.parametrize("case", range(3))
def test_plain_versions_match_pallas_interpret(case):
    """A few tiny cases against the Pallas kernels themselves, run in
    interpret mode on the CPU."""
    rng = np.random.default_rng(200 + case)
    n_q, tau, kw, num_sets = ((4, 128, 2, 3), (7, 32, 1, 5), (8, 4, 3, 2))[case]
    masks = rng.integers(0, 256, (n_q, tau)).astype(np.uint8)
    f = _rand_words(rng, (num_sets, 8, kw), empty=0)
    v2r = rng.integers(0, num_sets, n_q).astype(np.int32)
    jm, jf, jv = jnp.asarray(masks), jnp.asarray(f), jnp.asarray(v2r)
    _eq(_u32(ops.pull_ms_packed(_t(masks), _t(f.view(np.int32)), _t(v2r))),
        j_pmp.pull_ms_packed(jm, jf, jv, interpret=True))
    a = rng.integers(-2, 2, (8, tau, 8)).astype(np.int8)
    va = rng.integers(0, num_sets, 8).astype(np.int32)
    _eq(_u32(ops.pull_mma_ms_packed(_t(a), _t(f.view(np.int32)), _t(va))),
        j_mma.pull_mma_ms_packed(jnp.asarray(a), jf, jnp.asarray(va),
                                 interpret=True))
    dest = _rand_words(rng, (num_sets + 4, kw), empty=0)
    rows = rng.integers(0, num_sets + 4, n_q * 2).astype(np.int32)
    marks = _rand_words(rng, (n_q * 2, kw), empty=0)
    _eq(_u32(ops.scatter_or(_t(dest.view(np.int32)), _t(rows).long(),
                            _t(marks.view(np.int32)))),
        j_so.scatter_or(jnp.asarray(dest), jnp.asarray(rows),
                        jnp.asarray(marks), interpret=True))


def _misaligned_graph():
    rng = np.random.default_rng(11)
    n = 211  # prime: n % 32, n % 8, n % 256 all nonzero
    return n, rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)


@pytest.mark.parametrize("block", MMA_BLOCKS)
def test_prep_mma_tiles_matches_reference(block):
    """On the misaligned n = 211: planes, parents and the compacted twin
    equal repro's; rows equal repro's wherever a mask is nonzero and on the
    pad tiles (n_pad), and are the port's spread rows elsewhere.  Repro's
    own tiles, carried over by mma_tiles_from_numpy, are its arrays."""
    n, src, dst = _misaligned_graph()
    jbd = j_blest.to_device(j_build(j_from_edges(src, dst, n=n)))
    bd = blest.to_device(build_bvss(from_edges(src, dst, n=n)), device="cpu")
    jt = j_mma.prep_mma_tiles(jbd, block=block)
    tiles = mma.prep_mma_tiles(bd, block=block)
    assert tiles.block == jt.block == block
    assert tiles.a_planes.shape[0] % block == 0
    for name in ("a_planes", "v2r", "nz_planes"):
        got, want = getattr(tiles, name), np.asarray(getattr(jt, name))
        assert got.numpy().dtype == want.dtype, name
        _eq(got, want)
    rows, jrows = tiles.rows.numpy(), np.asarray(jt.rows)
    real = np.zeros(rows.size, bool)
    real[: bd.masks.numel()] = bd.masks.numpy().ravel() != 0
    _eq(rows[real], jrows[real])
    pad = slice(bd.masks.numel(), None)
    assert (rows[pad] == bd.n_pad).all() and (jrows[pad] == bd.n_pad).all()
    _eq(rows[: bd.masks.numel()], bd.row_ids.reshape(-1))
    carried = mma.mma_tiles_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in
         ("a_planes", "v2r", "rows", "nz_planes")} | {"block": jt.block},
        device="cpu")
    assert carried.rows.dtype == torch.int64
    for name in ("a_planes", "v2r", "rows", "nz_planes"):
        _eq(getattr(carried, name), np.asarray(getattr(jt, name)))
    assert carried.nbytes == tiles.nbytes  # rows int64 in both


def test_pull_mma_rejects_ragged_tiles():
    """A VSS count that is not a multiple of the block is refused before any
    launch, on either device, as repro refuses it."""
    bd = _rand_bd(np.random.default_rng(0))
    tiles = mma.prep_mma_tiles(bd, block=8)
    f = frontier_planes(bd, torch.zeros((bd.n_ext, 1), dtype=torch.int32))
    bad = tiles.a_planes.shape[0] + 8  # never divides n_q_pad
    with pytest.raises(ValueError, match="pad-and-mask"):
        ops.pull_mma_ms_packed(tiles.a_planes, f, tiles.v2r, sigma=bd.sigma,
                               block=bad)
    with pytest.raises(ValueError, match="pad-and-mask"):
        mma.pull_mma_ms_packed(tiles.a_planes, f, tiles.v2r, sigma=bd.sigma,
                               block=bad)
    with pytest.raises(ValueError, match="pad-and-mask"):
        j_mma.pull_mma_ms_packed(
            jnp.asarray(tiles.a_planes.numpy()), jnp.zeros(
                (bd.num_sets_ext, bd.sigma, 1), jnp.uint32),
            jnp.asarray(tiles.v2r.numpy()), sigma=bd.sigma, block=bad,
            interpret=True)


@given_seeds(10)
def test_word_helpers_match_reference(seed):
    """SWAR popcount == lax.population_count; unpack/pack round-trip and
    match repro's shift-and-sum packing."""
    rng = np.random.default_rng(seed)
    w = _rand_words(rng, ((5, 17)[seed % 2], (1, 3)[seed // 2 % 2]),
                    empty=0.1)
    w[0, 0] = 0xFFFFFFFF
    tw = _t(w.view(np.int32))
    _eq(words.popcount32(tw), np.asarray(
        jax.lax.population_count(jnp.asarray(w))).astype(np.int32))
    bits = words.unpack_words(tw)
    _eq(bits, np.asarray(j_mma._unpack_words(jnp.asarray(w), w.shape[1])))
    _eq(_u32(words.pack_bits(bits.view(*w.shape, 32))), w)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_launch_a_kernel():
    ops.reset_launch_counts()
    bd = _rand_bd(np.random.default_rng(3))
    f8 = frontier_planes(bd, torch.ones((bd.n_ext, 8), dtype=torch.uint8))
    f32 = frontier_planes(bd, torch.full((bd.n_ext, 1), -1,
                                         dtype=torch.int32))
    ops.pull_ms(bd.masks, f8, bd.v2r, sigma=bd.sigma)
    marks = ops.pull_ms_packed(bd.masks, f32, bd.v2r, sigma=bd.sigma)
    ops.scatter_or(torch.zeros((bd.n_ext, 1), dtype=torch.int32),
                   bd.row_ids.reshape(-1), marks.reshape(-1, 1))
    tiles = mma.prep_mma_tiles(bd)
    ops.pull_mma_ms_packed(tiles.a_planes, f32, tiles.v2r, sigma=bd.sigma)
    assert set(ops.launch_counts().values()) == {0}
    assert {"pull_ms", "pull_ms_packed", "scatter_or",
            "pull_mma_ms_packed"} <= set(ops.launch_counts())


def test_ms_kernel_wrappers_take_cuda_tensors_only():
    """The kernel wrappers never fall back to a plain version: a CPU tensor
    is refused before any build or launch."""
    m = torch.zeros((8, 4), dtype=torch.uint8)
    v2r = torch.zeros(8, dtype=torch.int32)
    fb = torch.zeros((2, 8, 8), dtype=torch.uint8)
    fw = torch.zeros((2, 8, 1), dtype=torch.int32)
    a = torch.zeros((8, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pull_ms.pull_ms(m, fb, v2r)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pmp.pull_ms_packed(m, fw, v2r)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_so.scatter_or(fw[0], v2r, fw[1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        mma.pull_mma_ms_packed(a, fw, v2r)
