"""GPU-RMQ on PyTorch and CUDA: the range-minimum hierarchy on an H100.

The port of ``repro`` (the JAX/TPU package, which stays the reference):
the same plan geometry, hierarchy layout and inclusive-bound query
convention, with the Pallas kernels rewritten as hand-written CUDA
kernels for Hopper (``csrc/``).  Entry points run on the card unless the
caller passes ``device="cpu"``:

    from repro_torch.core import RMQ

    rmq = RMQ.build(x, with_positions=True, backend="fused")
    vals = rmq.query(ls, rs)          # batched RMQ_value
    pos = rmq.query_index(ls, rs)     # batched RMQ_index (leftmost)
"""
