"""Hand-written CUDA kernels of the port, one package per kernel.

Each ``ops.py`` holds the wrapper (launch on a CUDA tensor, the plain
PyTorch version beside it on a CPU tensor) and its launch counter.
"""
