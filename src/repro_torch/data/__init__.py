"""Synthetic stand-ins for the paper's graph families (a copy of
``repro.data.graphs``)."""
