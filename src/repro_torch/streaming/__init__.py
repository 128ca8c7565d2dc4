"""Streaming RMQ of the port: incremental hierarchy maintenance.

    from repro_torch.streaming import StreamingRMQ

    s = StreamingRMQ.from_array(x, c=128, t=64, capacity=2 * len(x),
                                with_positions=True)   # on the card
    s = s.update(idxs, vals)     # batched point updates (last wins)
    s = s.append(new_tail)       # grow into reserved capacity
    s = s.retire(1024)           # slide the window
    pos = s.query_index(ls, rs)  # the same query surface as RMQ
"""

from repro_torch.streaming.structure import StreamingRMQ
from repro_torch.streaming.updates import append_hierarchy, update_hierarchy

__all__ = ["StreamingRMQ", "append_hierarchy", "update_hierarchy"]
