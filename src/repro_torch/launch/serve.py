"""LM serving launcher: continuous-batched decode over the
:class:`repro_torch.serve.serve_loop.BatchEngine` slot engine, on the CUDA
device (``--device cpu`` for the CPU).

    python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        [--reduced] [--requests 8] [--max-new 16] [--slots 4] \
        [--max-seq 256] [--dtype float32]

(with ``src`` on ``PYTHONPATH``).  The flags and the output line are those
of ``repro.launch.serve``; ``--device`` and ``--dtype`` (the weights' and
the KV cache's dtype, the config's own by default) are the port's.  The
weights are random, drawn from seed 0 on the device.  The graph-query
counterpart is ``repro_torch.launch.serve_bfs``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Served:
    """What :func:`main` ran: the model, the engine, its requests, the
    seconds the weights took to draw and the serving took."""
    cfg: object
    model: object
    engine: object
    requests: list
    init_s: float
    seconds: float


def main(argv=None) -> Served:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--dtype", default=None,
                    help="dtype of the weights and the KV cache (default: "
                         "the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    import repro_torch.configs as configs
    from repro_torch.core.blest import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve.serve_loop import BatchEngine, Request

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype,
                                  kv_cache_dtype=args.dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=device)
    sync()
    init_s = time.perf_counter() - t0
    eng = BatchEngine(cfg, model, slots=args.slots, max_seq=args.max_seq,
                      eos=-1)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4 + i % 8),
                    max_new=args.max_new) for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run_until_done()
    sync()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {tokens} tokens "
          f"in {dt:.2f}s ({tokens / dt:.1f} tok/s)")
    return Served(cfg, model, eng, done, init_s, dt)


if __name__ == "__main__":
    main()
