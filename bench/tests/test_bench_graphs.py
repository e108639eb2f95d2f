"""The benchmark's generators at a tiny scale: counts, symmetry, no
self-loop or duplicate, and the seed's effect."""
import pytest
import torch

from bench import graphs


def _kron(scale, seed=7):
    cfg = {"generator": "kronecker", "scale": scale, "edge_factor": 16,
           "a": 0.57, "b": 0.19, "c": 0.19, "undirected": True}
    return graphs.generate(cfg, seed, "cpu")


def _pairs(es):
    return set(zip(es.src.tolist(), es.dst.tolist()))


def test_kronecker_is_symmetric_without_loops_or_duplicates():
    es = _kron(8)
    pairs = _pairs(es)
    assert es.n == 256
    assert len(pairs) == es.m  # no duplicate
    assert all(s != d for s, d in pairs)
    assert pairs == {(d, s) for s, d in pairs}
    # 16 * 256 pairs drawn, both directions kept, some repeat or loop
    assert 0.5 * 2 * 16 * 256 < es.m <= 2 * 16 * 256
    assert int(es.out_degree.sum()) == es.m


def test_kronecker_follows_the_seed():
    a, b, c = _kron(8, 1), _kron(8, 1), _kron(8, 2)
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert _pairs(a) != _pairs(c)


def test_kronecker_takes_large_seeds():
    assert _kron(6, 2**31 + 987654321).m > 0


def test_edges_sorted_and_csr_csc():
    es = _kron(7)
    key = es.src * es.n + es.dst
    assert torch.equal(key, torch.sort(key).values)
    ptr, col = es.csr()
    assert int(ptr[-1]) == es.m and torch.equal(col, es.dst)
    cptr, row = es.csc()
    # symmetric: the in-neighbours are the out-neighbours
    assert torch.equal(cptr, ptr) and torch.equal(row, col)


def test_permuted_kronecker_is_a_relabelling():
    """Graph500's permutation: the same graph under other vertex ids."""
    cfg = {"generator": "kronecker", "scale": 8, "edge_factor": 16,
           "a": 0.57, "b": 0.19, "c": 0.19, "undirected": True}
    plain = graphs.generate(cfg, 5, "cpu")
    perm = graphs.generate(dict(cfg, permute_vertices=True), 5, "cpu")
    assert perm.m == plain.m
    assert torch.equal(torch.sort(perm.out_degree).values,
                       torch.sort(plain.out_degree).values)
    assert not torch.equal(perm.out_degree, plain.out_degree)
    # R-MAT's hubs are the ids with the fewest bits set; the permutation
    # leaves no such pattern
    def bits(es):
        return sum(bin(h).count("1")
                   for h in torch.topk(es.out_degree, 8).indices.tolist())
    assert bits(plain) <= 8 < bits(perm)


def test_generator_found_by_name():
    from bench import spec
    assert spec.generator("kronecker") is not None
    with pytest.raises(FileNotFoundError):
        spec.generator("no_such_generator")
