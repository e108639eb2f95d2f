"""The kernel-count files against ``chip_smoke.py``'s figures for the same
shapes, and the recorder of launch shapes."""
import sys
import types

import numpy as np
import pytest
import torch

from bench import counts, peaks, spec
from bench.tests.conftest import ROOT


@pytest.fixture(scope="module")
def smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def count_files():
    return {m.KERNEL: m for m in spec.kernel_counts()}


def _bd(n_v=1000, tau=128, sigma=8, n_ext=8200):
    masks = torch.zeros((n_v, tau), dtype=torch.uint8)
    return types.SimpleNamespace(masks=masks, masks_packed=masks.view(
        torch.int32), sigma=sigma, n_ext=n_ext)


def _stub(smoke):
    """Enough of ``chip_smoke.Smoke`` for its production rows' bounds."""
    stub = types.SimpleNamespace(np=np, t=torch.as_tensor)
    stub.sweep_inputs = types.MethodType(smoke.Smoke.sweep_inputs, stub)
    stub.kernels = {k: dict(fn=lambda *a, **kw: None,
                            plain=lambda *a, **kw: None, source="",
                            replaces="", max_abs_err=0)
                    for k in ("pull_ss", "pull_ss_packed", "frontier_sweep")}
    stub.same = lambda *a: None
    stub.time_ms = stub.time_graph_ms = lambda fn: 1.0
    return stub


def _bound_ms(mod, *args, **kwargs):
    return peaks.bound_s(*mod.counts(*args, **kwargs)) * 1e3


@pytest.mark.parametrize("n_v, tau, n_ext", [(1000, 128, 8200),
                                             (806384, 128, 4194312),
                                             (77, 16, 1024)])
def test_single_source_counts_match_chip_smoke(smoke, count_files, n_v, tau,
                                               n_ext):
    bd = _bd(n_v, tau, 8, n_ext)
    rows = {r["name"]: r for r in smoke.Smoke.production_kernels(
        _stub(smoke), bd, {"pull_ss": 0, "pull_ss_packed": 0,
                           "frontier_sweep": 0})}
    alphas = counts.Arg((n_v,), 1)
    got = _bound_ms(count_files["pull_ss_packed"],
                    counts.Arg((n_v, tau // 4), 4), alphas)
    assert got == pytest.approx(rows["pull_ss_packed"]["bound_ms"], rel=1e-12)
    v = counts.Arg((n_ext,), 1)
    got = _bound_ms(count_files["frontier_sweep"], v, v,
                    counts.Arg((n_ext,), 4), 3, sigma=8)
    assert got == pytest.approx(rows["frontier_sweep"]["bound_ms"], rel=1e-12)


@pytest.mark.parametrize("n_v, tau, sets, sigma, kappa", [
    (806384, 128, 524289, 8, 64), (100, 16, 33, 4, 3)])
def test_pull_ms_counts_match_chip_smoke(smoke, count_files, n_v, tau, sets,
                                         sigma, kappa):
    bd = types.SimpleNamespace(masks=torch.zeros((n_v, tau),
                                                 dtype=torch.uint8),
                               v2r=torch.zeros(n_v, dtype=torch.int32))
    f = torch.zeros((sets, sigma, kappa), dtype=torch.uint8)
    _, nbytes, nops, peak = smoke.Smoke.pull_ms_cell(None, bd, f)
    got = count_files["pull_ms"].counts(
        counts.Arg((n_v, tau), 1), counts.Arg((sets, sigma, kappa), 1),
        counts.Arg((n_v,), 4), sigma=sigma)
    assert got[:2] == (nbytes, nops)
    assert peaks.PEAKS[got[2]] == peak


def test_peaks_are_chip_smokes(smoke):
    assert peaks.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert peaks.ALU_OPS_PER_S == smoke.ALU_OPS_PER_S
    assert peaks.INT8_MMA_OPS_PER_S == smoke.INT8_MMA_OPS_PER_S


def test_every_count_claims_port_kernels(count_files):
    from bench import trace
    port = trace.port_kernel_names()
    for mod in count_files.values():
        assert mod.DEVICE_FUNCTIONS and set(mod.DEVICE_FUNCTIONS) <= port


def test_recorder_records_shapes_and_restores(monkeypatch):
    fake = types.ModuleType("bench_fake_kernels")

    def kern(x, y, *, k=1):
        return x.sum() + y

    kern.launches = 0
    fake.kern = kern
    monkeypatch.setitem(sys.modules, "bench_fake_kernels", fake)
    mod = types.SimpleNamespace(
        __name__="fake", WRAPPER=("bench_fake_kernels", "kern"),
        DEVICE_FUNCTIONS=("kern_kernel",),
        counts=lambda x, y, k=1: (x.numel() * x.itemsize, 0, "alu"))
    rec = counts.ShapeRecorder([mod])
    rec.install()
    assert fake.kern is not kern
    fake.kern(torch.zeros(10, dtype=torch.int32), 2, k=3)
    fake.kern(torch.zeros(10, dtype=torch.int32), 2, k=3)
    rec.uninstall()
    assert fake.kern is kern
    bounds, notes = rec.bounds()
    assert bounds == {"kern_kernel": 40 / peaks.HBM_BYTES_PER_S}
    assert notes == []
