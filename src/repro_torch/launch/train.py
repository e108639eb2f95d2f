"""LM training launcher, on the CUDA device (``--device cpu`` for the
CPU): the counterpart of ``repro.launch.train``.

    python -m repro_torch.launch.train \
        --arch tinyllama-1.1b --shape train_4k --steps 100 \
        --ckpt CKPT_DIR [--microbatches 4] [--mesh-model 2] \
        [--devices 4] [--device cuda:0] [--log-every 10]

(with ``src`` on ``PYTHONPATH``).  The flags and the printed lines are
repro's; the port adds ``--device``, ``--devices`` and ``--log-every``
(the history's spacing, 10 steps as repro's loop).  The loop resumes from
the newest complete checkpoint in ``--ckpt`` after any restart, and a
checkpoint written by either package resumes in the other.

``--devices N`` trains on a slot mesh of N slots, (N / --mesh-model) data
x --mesh-model model: the first N CUDA devices, or, with ``--device D``,
N slots on D (``--devices 4 --device cpu`` stands for four host devices;
``--device cuda:0`` puts four slots on one card).  Without ``--devices``
the mesh holds every CUDA device (one slot on ``--device`` where given),
and a one-slot mesh trains on that device alone, as repro's launcher does.
``--distributed`` (repro: ``jax.distributed.initialize()``, one process a
host) raises: the port drives every slot from one process, and training
over several processes (``torch.distributed`` / NCCL) is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

DISTRIBUTED = ("--distributed: multi-process training over torch.distributed "
               "/ NCCL is not ported (NCCL cannot run two ranks on one GPU); "
               "one process drives the slots of --devices")


@dataclasses.dataclass
class Trained:
    """What :func:`main` ran: the config, the mesh (None on one device),
    ``train()``'s result and its wall seconds."""
    cfg: object
    mesh: object
    out: dict
    seconds: float


def main(argv=None) -> Trained:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-parallel axis size (slots/model)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced config")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training (not ported: raises)")
    ap.add_argument("--devices", type=int, default=None,
                    help="slots of the mesh (default: every CUDA device; "
                         "with --device D, N slots on D)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between history lines (default 10)")
    args = ap.parse_args(argv)

    if args.distributed:
        raise NotImplementedError(DISTRIBUTED)

    import torch

    import repro_torch.configs as configs
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.core.blest import resolve_device
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES[args.shape]
    if args.seq_len or args.global_batch:
        shape = ShapeConfig(shape.name, args.seq_len or shape.seq_len,
                            args.global_batch or shape.global_batch,
                            shape.kind)

    if args.devices is not None and args.devices < 1:
        ap.error(f"--devices must be >= 1, got {args.devices}")
    if args.device is not None:
        slots = [device] * (args.devices or 1)
    else:
        slots = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if args.devices is not None:
            if args.devices > len(slots):
                ap.error(f"--devices must be in [1, {len(slots)}], "
                         f"got {args.devices}")
            slots = slots[:args.devices]
    mesh = make_local_mesh(model=args.mesh_model, devices=slots)
    data = synthetic.DataConfig()

    def batch_fn(step):
        return synthetic.batch_for_step(cfg, shape, data, step)

    t0 = time.perf_counter()
    out = train_loop.train(
        cfg,
        steps=args.steps,
        batch_fn=batch_fn,
        opt_cfg=O.AdamWConfig(lr=args.lr),
        mesh=mesh if mesh.size > 1 else None,
        shape=shape,
        checkpoint_dir=args.ckpt,
        checkpoint_every=args.ckpt_every,
        microbatches=args.microbatches,
        log_every=args.log_every,
        device=device,
    )
    seconds = time.perf_counter() - t0
    for h in out["history"]:
        print(f"step {h['step']:6d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  {h['time_s'] * 1e3:.0f} ms")
    if out["straggler_events"]:
        print(f"straggler events: {len(out['straggler_events'])}")
    return Trained(cfg, mesh if mesh.size > 1 else None, out, seconds)


if __name__ == "__main__":
    main()
