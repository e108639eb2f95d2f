"""``preprocess_s``: the port's host preprocessing, as ``Blest.stats``
records it on the host's clock: CSR and CSC (``core/graph``), the reorder
(``core/reorder``) and the BVSS with its upload (``core/bvss``,
``core/blest.to_device``).  It should move ``setup_s``."""


def read(run):
    st = run["stats"]
    return st.csc_s + st.reorder_s + st.bvss_s
