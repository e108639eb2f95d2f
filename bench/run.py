"""Runs one cell of ``BENCHMARK.json`` once and prints its result.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit, which the last
lines of standard error repeat).  With ``--trace 0`` the metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones.

A run writes only under ``build/`` of the checkout (the port's kernel
libraries in ``build/repro_torch``, other caches in ``build/bench``).  It
exits non-zero with no result when there is no CUDA device, fewer than the
cell asks for, no port beside it (``src/repro_torch``), or when JAX or the
JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda_cache"}


def fail(msg: str, code: int) -> None:
    print(f"bench.run: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        fail("--seed must be >= 0 and --seconds > 0", 2)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench" / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no port at {ROOT / 'src' / 'repro_torch'}: run from a "
             f"checkout of the repository", 2)
    sys.path.insert(0, str(ROOT / "src"))

    import torch

    from bench import cell as cell_mod
    from bench import spec

    try:
        cell = spec.load_cell(args.workload, ROOT)
    except KeyError as e:
        fail(str(e), 2)
    if not torch.cuda.is_available():
        fail("no CUDA device", 1)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA devices, found "
             f"{torch.cuda.device_count()}", 1)
    result, forbidden = cell_mod.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), device="cuda",
        t0=T0, root=ROOT)
    forbidden = sorted(set(forbidden) | set(cell_mod.forbidden_modules()))
    if forbidden:
        fail(f"modules of JAX or the JAX package were loaded: {forbidden}", 4)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['holds']} "
              f"{c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
