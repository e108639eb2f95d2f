"""The serve engine: ``bfs_engine`` batches independent traversal queries
into shared packed multi-source traversals (kappa lanes, continuous
batching, per-level dense/queued mode switching gated by a cached per-graph
probe) behind a ticket-based, non-blocking service API with a hardened
request lifecycle (``lifecycle``); what a lane computes is a
:class:`~repro_torch.serve.workloads.Workload` plugin (``workloads``:
``bfs``/``closeness``/``distance``/``reach`` and the graph-analytics
kinds ``cc``/``mis``/``tpv``, with their per-graph state, built in;
``register`` for more), with megatick windows of up to T levels on the
device, and mesh serving over a group of device slots (``mesh``).
Counterpart of ``repro.serve``."""
