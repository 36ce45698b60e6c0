"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(ref.py) and the dispatcher (ops.py)."""
