"""Kernel modules of the PyTorch port against the JAX package's.

On CPU tensors ``repro_torch.kernels.ops`` runs the plain PyTorch versions;
they must equal ``repro.kernels.ref`` on the same numpy inputs over the
shape pool of tests/test_kernel_parity.py (random graphs, ragged n, empty
frontiers), and, for a few tiny cases, the Pallas kernels in interpret mode.
Outputs are bits and integers: equality is exact (tolerance 0).  The CUDA
kernels themselves run only on a GPU; chip_smoke.py holds them against these
plain versions there.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hypothesis_shim import given_seeds  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core.bvss import BvssConfig, build_bvss  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.kernels import frontier_sweep as t_sweep  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pull_ss as t_pull  # noqa: E402

CASES = 30
# (n, sigma, tau): the pool of tests/test_kernel_parity.py
SHAPES = (
    (3, 8, 1),
    (8, 8, 2),
    (12, 4, 2),
    (9, 2, 4),
    (21, 2, 1),
    (33, 8, 2),
    (19, 4, 4),
    (24, 8, 2),
)
# the packed layout needs tau % 4 == 0: the pool's tau=4 shapes plus wider
PACKED_SHAPES = ((9, 2, 4), (19, 4, 4), (40, 8, 32), (70, 8, 128))


def _masks(rng, shapes):
    """Masks of a random tiny graph (isolated vertices routine, m may be 0)
    and its sigma."""
    n, sigma, tau = shapes[int(rng.integers(len(shapes)))]
    m = int(rng.integers(0, 3 * n + 1))
    g = Graph(n=n, src=rng.integers(0, n, m), dst=rng.integers(0, n, m))
    return build_bvss(g, BvssConfig(sigma=sigma, tau=tau)).masks, sigma


def _alphas(rng, n_v, sigma):
    """Frontier words, all zero (an empty frontier) in ~15% of cases."""
    if rng.random() < 0.15:
        return np.zeros(n_v, np.uint8)
    return rng.integers(0, 1 << sigma, n_v).astype(np.uint8)


def _sweep_inputs(rng, sigma):
    n = sigma * int(rng.choice((1, 5, 17, 33)))  # few shapes: jax compiles each
    v_curr = rng.integers(0, 2, n).astype(np.uint8)
    v_next = v_curr | (rng.random(n) < 0.3).astype(np.uint8)
    if rng.random() < 0.15:
        v_next = v_curr.copy()  # nothing new: empty next frontier
    level = rng.integers(0, 50, n).astype(np.int32)
    return v_curr, v_next, level, int(rng.integers(1, 60))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _words(masks: np.ndarray) -> np.ndarray:
    return np.asarray(j_ops.pack_masks(jnp.asarray(masks)))  # uint32


@given_seeds(CASES)
def test_pull_ss_matches_reference(seed):
    rng = np.random.default_rng(seed)
    masks, sigma = _masks(rng, SHAPES)
    alphas = _alphas(rng, masks.shape[0], sigma)
    out = ops.pull_ss(_t(masks), _t(alphas))
    assert out.dtype == torch.uint8
    _eq(out, j_ref.pull_ss_ref(jnp.asarray(masks), jnp.asarray(alphas)))


@given_seeds(CASES)
def test_pull_ss_packed_matches_reference(seed):
    rng = np.random.default_rng(seed)
    masks, sigma = _masks(rng, PACKED_SHAPES)
    alphas = _alphas(rng, masks.shape[0], sigma)
    words = _words(masks)
    out = ops.pull_ss_packed(_t(words.view(np.int32)), _t(alphas))
    assert out.dtype == torch.int32
    want = j_ref.pull_ss_packed_ref(jnp.asarray(words), jnp.asarray(alphas))
    _eq(out.numpy().view(np.uint32), want)
    # the two layouts give the same marks
    _eq(ops.unpack_marks(out), ops.pull_ss(_t(masks), _t(alphas)))


@given_seeds(CASES)
def test_frontier_sweep_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sigma = (1, 2, 4, 8)[seed % 4]
    v_curr, v_next, level, ell = _sweep_inputs(rng, sigma)
    got = ops.frontier_sweep(_t(v_curr), _t(v_next), _t(level), ell,
                             sigma=sigma)
    want = j_ref.frontier_sweep_ref(jnp.asarray(v_curr), jnp.asarray(v_next),
                                    jnp.asarray(level), jnp.int32(ell),
                                    sigma=sigma)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, str(np.asarray(w).dtype))
        _eq(g, w)


@given_seeds(CASES)
def test_pack_and_unpack_match_reference(seed):
    """The zero-copy views are the reference's shift-and-sum packing."""
    rng = np.random.default_rng(seed)
    masks, _ = _masks(rng, PACKED_SHAPES)
    _eq(ops.pack_masks(_t(masks)).numpy().view(np.uint32), _words(masks))
    marks = rng.integers(0, 2, masks.shape).astype(np.uint8)
    words = _words(marks)
    _eq(ops.unpack_marks(_t(words.view(np.int32))),
        j_ops.unpack_marks(jnp.asarray(words)))


@pytest.mark.parametrize("case", range(3))
def test_plain_versions_match_pallas_interpret(case):
    """A few tiny cases against the Pallas kernels themselves, run in
    interpret mode on the CPU."""
    rng = np.random.default_rng(100 + case)
    masks, sigma = _masks(rng, PACKED_SHAPES[:2])
    alphas = _alphas(rng, masks.shape[0], sigma)
    jm, ja = jnp.asarray(masks), jnp.asarray(alphas)
    _eq(ops.pull_ss(_t(masks), _t(alphas)),
        j_ops.pull_ss(jm, ja, use_pallas=True, interpret=True))
    words = _words(masks)
    _eq(ops.pull_ss_packed(_t(words.view(np.int32)), _t(alphas))
        .numpy().view(np.uint32),
        j_ops.pull_ss_packed(jnp.asarray(words), ja, use_pallas=True,
                             interpret=True))
    v_curr, v_next, level, ell = _sweep_inputs(rng, sigma)
    got = ops.frontier_sweep(_t(v_curr), _t(v_next), _t(level), ell,
                             sigma=sigma)
    want = j_ops.frontier_sweep(jnp.asarray(v_curr), jnp.asarray(v_next),
                                jnp.asarray(level), jnp.int32(ell),
                                sigma=sigma, use_pallas=True, interpret=True)
    for g, w in zip(got, want):
        _eq(g, w)


def test_cpu_tensors_never_launch_a_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    masks, sigma = _masks(rng, PACKED_SHAPES)
    alphas = _t(_alphas(rng, masks.shape[0], sigma))
    ops.pull_ss(_t(masks), alphas)
    ops.pull_ss_packed(ops.pack_masks(_t(masks)), alphas)
    v_curr, v_next, level, ell = _sweep_inputs(rng, sigma)
    ops.frontier_sweep(_t(v_curr), _t(v_next), _t(level), ell, sigma=sigma)
    counts = ops.launch_counts()
    assert {"pull_ss", "pull_ss_packed", "frontier_sweep"} <= set(counts)
    assert set(counts.values()) == {0}


def test_kernel_wrappers_take_cuda_tensors_only():
    """The kernel wrappers never fall back to a plain version: a CPU tensor
    is refused before any build or launch."""
    m = torch.zeros((8, 4), dtype=torch.uint8)
    a = torch.zeros(8, dtype=torch.uint8)
    v = torch.zeros(16, dtype=torch.uint8)
    lv = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pull.pull_ss(m, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pull.pull_ss_packed(m.view(torch.int32), a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_sweep.frontier_sweep(v, v, lv, 1, sigma=8)


def test_pack_masks_rejects_ragged_words():
    with pytest.raises(ValueError, match="tau=6"):
        ops.pack_masks(torch.zeros((3, 6), dtype=torch.uint8))
