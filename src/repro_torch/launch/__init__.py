"""CLI entry points of the port (``python -m repro_torch.launch.<name>``):
graph workloads (``bfs``), the batched graph-query service
(``serve_bfs``) and LM serving (``serve``), with ``repro.launch``'s flags
and output lines.  Each runs on the CUDA device unless given ``--device
cpu``, and has a ``main(argv=None)`` that tests call in-process."""
