"""The serve engine: ``bfs_engine`` batches independent traversal queries
into shared packed multi-source traversals (kappa lanes, continuous
batching, per-level dense/queued mode switching gated by a cached per-graph
probe) behind a ticket-based, non-blocking service API with a hardened
request lifecycle (``lifecycle``); what a lane computes is a
:class:`~repro_torch.serve.workloads.Workload` plugin (``workloads``:
``bfs``/``closeness``/``distance``/``reach`` built in, ``register`` for
more).  Counterpart of ``repro.serve``; megatick windows, the analytics
kinds and mesh serving are not ported yet (ROADMAP.md queue 1)."""
