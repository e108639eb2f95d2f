"""BLEST algorithms: graph container, BVSS, reordering, the single-source
drivers and their device layout, Eq. (6) switching, the pipeline
facade (``preprocess`` -> ``bfs``), and the BRS baseline of Table 2."""
