"""Batched serving example: continuous-batching decode over a small LM, on
the PyTorch port (``repro_torch``), on the CUDA device.

    PYTHONPATH=src python examples/port/serve_lm.py [--device cpu]

The counterpart of ``examples/serve_lm.py``: a narrow tinyllama (4 layers,
d_model 256) with random weights serves 8 requests over 4 slots, and
every request finishes with its 8 new tokens.
"""
import argparse
import dataclasses

import numpy as np

import repro_torch.configs as configs
from repro_torch.models import model as M
from repro_torch.serve.serve_loop import BatchEngine, Request


def main(device=None):
    cfg = dataclasses.replace(
        configs.get("tinyllama-1.1b"),
        n_layers=4, d_model=256, n_heads=4, n_kv=2, d_ff=512, vocab=1024,
        head_dim=64, remat="none", attn_block_k=128)
    model = M.init_params(cfg, seed=0, device=device)

    eng = BatchEngine(cfg, model, slots=4, max_seq=128, eos=-1)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4 + 2 * i),
                    max_new=8) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_done()
    for r in done:
        print(f"req {r.rid}: prompt_len={len(r.prompt)} -> {r.generated}")
    if not all(r.done and len(r.generated) == 8 for r in done):
        raise AssertionError("a request did not finish with 8 new tokens")
    print("all requests served ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
