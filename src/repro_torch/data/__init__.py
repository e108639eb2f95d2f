"""Data generators: synthetic stand-ins for the paper's graph families
(``graphs``, a copy of ``repro.data.graphs``) and the deterministic,
stateless token-stream pipeline of the LM substrate (``synthetic``, a copy
of ``repro.data.synthetic``)."""
