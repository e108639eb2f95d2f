"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The profiler runs over a fixed part of the window, its last
:data:`PROFILED_SECONDS` (the last third of a window shorter than three
times that), so the part before it is timed as in an untraced run.  Its
events stay in memory: no Chrome trace is written.  :func:`summarize`
reduces them to what the per-layer metrics and the result's ``breakdown``
read:

* device activity (kernels, copies, fills) clipped to the profiled span,
  whose union is ``busy_s``;
* the port's kernels, told apart from PyTorch's by name: a device function
  declared ``__global__`` in ``src/repro_torch/kernels/csrc``;
* each port kernel's roofline bound from ``bench/kernel_counts`` (a kernel
  no count file claims is named and counts with a bound of 0);
* the longest idle gaps, each named by the host work under way when it
  began.
"""
from __future__ import annotations

import re

from torch.autograd import DeviceType

from bench import spec

PROFILED_SECONDS = 5.0
PROFILED_SPAN = "bench.profiled"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160


def profiled_seconds(seconds: float) -> float:
    return min(PROFILED_SECONDS, seconds / 3)


def port_kernel_names(root=spec.ROOT) -> set[str]:
    """Every ``__global__`` function of the port's CUDA sources."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)")
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    for path in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(path.read_text()))
    return names


def base_name(name: str) -> str:
    """A device function's identifier from the profiler's demangled name:
    no return type, namespace, template or parameter list."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    m = re.match(r"[\w:]+", s)
    return m.group(0).split("::")[-1] if m else name


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _union(intervals):
    """Merged, sorted (lo, hi) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def _length(merged) -> int:
    return sum(hi - lo for lo, hi in merged)


def _kind(e) -> str:
    """The event's activity type, also where the profiler's event has no
    ``activity_type`` (it names copies and fills by their names)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    user = e.is_user_annotation() if hasattr(e, "is_user_annotation") \
        else e.name().startswith("bench.")
    if e.device_type() != DeviceType.CUDA:
        return "user_annotation" if user else "cpu_op"
    if user:
        return "gpu_user_annotation"
    for prefix, kind in (("Memcpy", "gpu_memcpy"), ("Memset", "gpu_memset")):
        if e.name().startswith(prefix):
            return kind
    return "kernel"


def _span_ns(e) -> tuple[int, int]:
    a = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
    if hasattr(e, "end_ns"):
        return a, e.end_ns()
    return a, a + (e.duration_ns() if hasattr(e, "duration_ns")
                   else int(e.duration_us() * 1000))


def summarize(prof, bounds: dict[str, float], port_names: set[str]) -> dict:
    """The profiled span's device activity; every time in seconds."""
    events = [(_kind(e), e.name(), *_span_ns(e))
              for e in prof.profiler.kineto_results.events()]
    span = [(a, b) for kind, name, a, b in events
            if name == PROFILED_SPAN and kind == "user_annotation"]
    if not span:
        return {}
    lo, hi = span[0]
    device, host = [], []
    for kind, name, start, end in events:
        a, b = max(start, lo), min(end, hi)
        if name.startswith("bench."):
            if kind == "user_annotation" and name != PROFILED_SPAN:
                host.append((name, start, end))
        elif kind in DEVICE_KINDS:
            if b > a:
                device.append((kind, name, a, b))
        else:
            host.append((name, start, end))
    busy = _union([(a, b) for _, _, a, b in device])
    torch_k, by_name = [], {}
    port_ns, bound_ns, unclaimed = 0, 0.0, {}
    for kind, name, a, b in device:
        by_name[name] = by_name.get(name, 0) + (b - a)
        if kind != "kernel":
            continue
        base = base_name(name)
        if base not in port_names:
            torch_k.append((a, b))
            continue
        port_ns += b - a
        if base in bounds:
            bound_ns += bounds[base] * 1e9
        else:
            unclaimed[base] = unclaimed.get(base, 0) + (b - a) * 1e-9
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": _length(busy) * 1e-9,
        "torch_kernel_s": _length(_union(torch_k)) * 1e-9,
        "port_kernel_s": port_ns * 1e-9,
        "port_bound_s": bound_ns * 1e-9,
        "unclaimed": unclaimed,
        "device_events": len(device),
        "device_ops": [[n[:NAME_CHARS], t * 1e-9] for n, t in top_ops],
        "idle_gaps": [[_host_doing(host, a)[:NAME_CHARS], (b - a) * 1e-9]
                      for a, b in gaps],
    }


def _host_doing(host, t) -> str:
    """The innermost host event under way at ``t``; inside one of the
    benchmark's own spans, also the host operation that ended last."""
    inner = None
    last = None
    for name, a, b in host:
        if a <= t < b and (inner is None or a >= inner[1]):
            inner = (name, a)
        if b <= t and (last is None or b > last[1]):
            last = (name, b)
    if inner is None:
        return "idle host" + (f" after {last[0]}" if last else "")
    if inner[0].startswith("bench.") and last is not None:
        return f"{inner[0]} after {last[0]}"
    return inner[0]
