"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes build and
binding (``_build.py``), the plain PyTorch versions (``ref.py``), and the
device dispatch (``ops.py``)."""
