"""PyTorch/CUDA port of the BLEST BFS framework (``repro``) for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core/``, ``data/``, ``kernels/``)
and names, so the counterpart of each module sits at the same relative path.
It imports ``torch`` and numpy only: never ``jax`` and never ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a tensor's device picks the path of every kernel (the
hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version for a
CPU tensor).  Ported so far: single- and multi-source BLEST BFS and
closeness through :class:`repro_torch.core.pipeline.Blest`, the packed
multi-source layout (``core/msbfs_packed``), the serve engine
(:class:`repro_torch.serve.bfs_engine.BfsEngine`) with the analytics
kinds, the BRS baseline (``core/brs_baseline``), multi-device BLEST and
mesh serving over a group of device slots (``core/distributed``,
``serve/mesh``), the launchers (``python -m repro_torch.launch.bfs``
/ ``.serve_bfs``), and the LM substrate's serving path: the model configs
(``configs``), the models (``models/{layers,moe,mamba2,model}``, with
``models/convert`` to load ``repro``'s parameter tree), the synthetic
token pipeline (``data/synthetic``), the continuous-batching
``serve.serve_loop.BatchEngine`` and ``python -m repro_torch.launch.serve``;
and its training path (``train/``: AdamW, the train step with remat and
microbatches, checkpoints in ``repro``'s format, ``repro``'s sharding
rules placed on a slot mesh, ``launch/mesh``) with ``python -m
repro_torch.launch.train``; and the dry-run of every cell on ``meta``
tensors with its roofline on the H100's constants (``python -m
repro_torch.launch.dryrun`` / ``.report``).
"""
