"""``set_condition`` (``csrc/blest_graph.cu``): the first node of every
level window's graph launch, which copies the window's one-byte ``go`` flag
into the graph's conditional handle.  One byte read; no wrapper launches it,
so its count needs no shapes."""

WRAPPER = None
DEVICE_FUNCTIONS = ("set_condition",)


def counts():
    return 1, 0, "alu"
