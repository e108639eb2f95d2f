"""End-to-end run: train a ~100M-param dense LM on synthetic data with
checkpoint / restart, on the PyTorch port (``repro_torch``), on the CUDA
device.

    PYTHONPATH=src python examples/port/train_lm.py [--steps 300] \
        [--ckpt CKPT_DIR] [--device cpu]

The counterpart of ``examples/train_lm.py``: tinyllama's geometry narrowed
to 12 x d768 with a 32k vocabulary, the same config system, data pipeline,
optimizer and fault-tolerant loop as ``repro_torch.launch.train``; asserts
that the loss went down.  With ``--ckpt`` it checkpoints every 100 steps
and a rerun resumes from the latest.
"""
import argparse
import dataclasses

import repro_torch.configs as configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic
from repro_torch.train import optimizer as O
from repro_torch.train import train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    # ~100M params: tinyllama geometry, narrowed (12 x d768 + 32k vocab)
    cfg = dataclasses.replace(
        configs.get("tinyllama-1.1b"),
        n_layers=12, d_model=768, n_heads=12, n_kv=4, d_ff=2048,
        vocab=32000, head_dim=64, remat="none", attn_block_k=256)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    shape = ShapeConfig("train_small", seq_len=256, global_batch=8,
                        kind="train")
    data = synthetic.DataConfig(seed=0)

    out = train_loop.train(
        cfg,
        steps=args.steps,
        batch_fn=lambda s: synthetic.batch_for_step(cfg, shape, data, s),
        opt_cfg=O.AdamWConfig(lr=3e-4, warmup_steps=20),
        checkpoint_dir=args.ckpt,
        checkpoint_every=100,
        log_every=20,
        device=args.device,
    )
    first, last = out["history"][0], out["history"][-1]
    print(f"loss: {first['loss']:.3f} (step {first['step']}) -> "
          f"{last['loss']:.3f} (step {last['step']})")
    if not last["loss"] < first["loss"]:
        raise AssertionError("training did not reduce loss")
    if args.ckpt:
        print("checkpoints in", args.ckpt, "- rerun to resume from the latest")
    return out


if __name__ == "__main__":
    main()
