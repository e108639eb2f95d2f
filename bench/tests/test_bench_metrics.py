"""The end-to-end arithmetic on made-up timings, and the trace reduction on
made-up profiler events."""
import types

import pytest

from bench import metrics, trace


def test_edges_per_s_is_all_the_work_over_all_the_window():
    assert metrics.edges_per_s([10, 20, 30], 2.0) == 30.0
    run = {"edges": [64, 64, 0], "window_s": 0.5}
    assert metrics.end_to_end("edges_per_s", run) == 256.0
    assert metrics.end_to_end("lane_edges_per_s", run) == 256.0


def test_p95_is_the_nearest_rank():
    times = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    assert metrics.p95_ms(times) == pytest.approx(95.0)
    assert metrics.p95_ms(times[:20]) == pytest.approx(19.0)
    assert metrics.p95_ms([0.005]) == pytest.approx(5.0)
    shuffled = times[50:] + times[:50]
    assert metrics.p95_ms(shuffled) == metrics.p95_ms(times)


def test_base_name():
    for name, base in [
            ("void (anonymous namespace)::pull_ss_items<2>(uint4 const*, "
             "unsigned char const*)", "pull_ss_items"),
            ("pull_ss_packed_kernel(unsigned int const*, unsigned char "
             "const*, unsigned int*, long, long)", "pull_ss_packed_kernel"),
            ("void frontier_sweep_items<8, true>(unsigned char const*)",
             "frontier_sweep_items"),
            ("void at::native::index_elementwise_kernel<128, 4>(long)",
             "index_elementwise_kernel"),
            ("Memcpy DtoH (Device -> Pageable)", "Memcpy")]:
        assert trace.base_name(name) == base


def test_port_kernel_names_come_from_the_sources():
    names = trace.port_kernel_names()
    assert {"pull_ss_packed_kernel", "frontier_sweep_items",
            "frontier_sweep_sets", "pull_ms_kernel",
            "set_condition"} <= names


class _Ev:
    def __init__(self, name, kind, a, b):
        self._n, self._k, self._a, self._b = name, kind, a, b

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b


class _OldEv:
    """An event as an older profiler gives it: no activity type."""

    def __init__(self, ev):
        self._e = ev

    def name(self):
        return self._e.name()

    def is_user_annotation(self):
        return self._e.activity_type() in ("user_annotation",
                                           "gpu_user_annotation")

    def device_type(self):
        from torch.autograd import DeviceType
        return (DeviceType.CUDA if self._e.activity_type() in (
            "kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
            else DeviceType.CPU)

    def start_ns(self):
        return self._e.start_ns()

    def duration_ns(self):
        return self._e.end_ns() - self._e.start_ns()


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


@pytest.mark.parametrize("old", [False, True])
def test_summarize(old):
    ns = 1_000_000  # 1 ms
    events = [
        _Ev(trace.PROFILED_SPAN, "user_annotation", 0, 100 * ns),
        _Ev("bench.query.bfs", "user_annotation", 0, 100 * ns),
        _Ev("aten::copy_", "cpu_op", 60 * ns, 70 * ns),
        # port kernels: 10 + 10 ms, bounds 4 ms each
        _Ev("void pull_ss_items<2>(x)", "kernel", 0, 10 * ns),
        _Ev("pull_ss_packed_kernel(y)", "kernel", 20 * ns, 30 * ns),
        # an unclaimed port kernel, 5 ms
        _Ev("set_condition(z)", "kernel", 30 * ns, 35 * ns),
        # torch: 15 ms, overlapping by 5; a copy of 10 ms
        _Ev("void at::native::foo<1>(z)", "kernel", 40 * ns, 50 * ns),
        _Ev("void at::native::bar(z)", "kernel", 45 * ns, 55 * ns),
        _Ev("Memcpy DtoH", "gpu_memcpy", 70 * ns, 80 * ns),
        # outside the span: clipped away
        _Ev("void at::native::foo<1>(z)", "kernel", 120 * ns, 130 * ns),
        # the span as the device's timeline shows it: not activity
        _Ev(trace.PROFILED_SPAN, "gpu_user_annotation", 0, 100 * ns),
    ]
    if old:
        events = [_OldEv(e) for e in events]
    bounds = {"pull_ss_items": 4e-3, "pull_ss_packed_kernel": 4e-3}
    port = {"pull_ss_items", "pull_ss_packed_kernel", "set_condition"}
    s = trace.summarize(_prof(events), bounds, port)
    assert s["window_s"] == pytest.approx(0.1)
    # busy: 0-10, 20-35, 40-55, 70-80 = 50 ms
    assert s["busy_s"] == pytest.approx(0.05)
    assert s["torch_kernel_s"] == pytest.approx(0.015)
    assert s["port_kernel_s"] == pytest.approx(0.025)
    assert s["port_bound_s"] == pytest.approx(0.008)
    assert s["unclaimed"] == {"set_condition": pytest.approx(0.005)}
    gaps = dict((round(t * 1e3), n) for n, t in s["idle_gaps"])
    # gaps: 10-20, 35-40, 55-70, 80-100
    assert sorted(gaps) == [5, 10, 15, 20]
    assert gaps[15] == "bench.query.bfs"
    assert gaps[20] == "bench.query.bfs after aten::copy_"
    assert s["device_ops"][0][1] == pytest.approx(0.01)


def test_per_layer_readers():
    from bench import spec
    t = {"window_s": 2.0, "busy_s": 1.5, "torch_kernel_s": 0.75,
         "port_kernel_s": 0.5, "port_bound_s": 0.25}
    run = {"trace": t, "unprofiled_s": 3.0, "unprofiled_levels": 1500,
           "stats": types.SimpleNamespace(csc_s=1.0, reorder_s=2.0,
                                          bvss_s=0.5)}
    read = {m: spec.layer_metric(m)(run) for m in (
        "torch_ops_pct", "kernel_roofline_pct", "device_idle_pct",
        "ms_per_level", "preprocess_s")}
    assert read == pytest.approx({"torch_ops_pct": 50.0,
                                  "kernel_roofline_pct": 50.0,
                                  "device_idle_pct": 25.0,
                                  "ms_per_level": 2.0, "preprocess_s": 3.5})
    empty = {"trace": {}, "unprofiled_s": None, "unprofiled_levels": None}
    for m in ("torch_ops_pct", "kernel_roofline_pct", "device_idle_pct",
              "ms_per_level"):
        assert spec.layer_metric(m)(empty) is None
        # the same reader for the cells of another end-to-end metric
        assert spec.layer_metric(m + ".lanes")(run) == read[m]
