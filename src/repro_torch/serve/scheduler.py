"""Request scheduler: priority classes, FIFO within a class, admission
control against the cache-memory budget.

Ordering is strict priority with head-of-line blocking: ``admit`` always
offers the front request of the highest non-empty priority class, and if
that request does not fit the currently free blocks/slots, nothing behind
it is admitted either.  No bypass means no starvation — a large request
at the head waits for retiring requests to return blocks, it can never be
overtaken indefinitely by smaller arrivals.  This module is the
reference's scheduler unchanged; ``tests/test_torch_serve.py`` holds the
two to the same admissions.

Admission reserves a request's *worst-case* block need up front
(``ceil((prompt_len + max_new_tokens) / block_size)``), so a request that
is admitted can always run to completion: the engine never deadlocks
waiting for blocks mid-generation.  A request whose worst case exceeds
the entire pool is rejected at ``submit`` — it could never be served.
"""
from __future__ import annotations

import collections
from typing import Dict, List


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block_size: int) -> int:
    """Worst-case cache blocks a request can touch over its lifetime."""
    return -(-(prompt_len + max_new_tokens) // block_size)


class PriorityScheduler:
    """Queues requests and decides admission.

    The scheduler is policy only — it never touches the cache.  The
    engine reports its free resources (``free_slots``, ``free_blocks``)
    and the scheduler hands back the requests to admit, in order, each
    tagged with its block reservation.
    """

    def __init__(self, total_blocks: int, block_size: int):
        self.total_blocks = total_blocks      # usable pool (excl. null block)
        self.block_size = block_size
        self._queues: Dict[int, collections.deque] = {}
        self._seq = 0                          # arrival stamp, FIFO tiebreak

    # -- introspection --------------------------------------------------

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_requests(self) -> List:
        """All queued requests, in the order ``admit`` would offer them."""
        out: List = []
        for prio in sorted(self._queues):
            out.extend(self._queues[prio])
        return out

    # -- policy ---------------------------------------------------------

    def reservation(self, req) -> int:
        return blocks_needed(len(req.prompt), req.max_new_tokens,
                             self.block_size)

    def submit(self, req) -> bool:
        """Enqueue ``req``; False = rejected as unservable (would never
        fit the pool even when it is completely empty)."""
        if self.reservation(req) > self.total_blocks:
            return False
        req.arrival_seq = self._seq
        self._seq += 1
        prio = getattr(req, "priority", 0)
        self._queues.setdefault(prio, collections.deque()).append(req)
        return True

    def admit(self, free_slots: int, free_blocks: int) -> List:
        """Pop the requests to admit now, highest priority first, FIFO
        within a class, stopping at the first that does not fit."""
        admitted: List = []
        while free_slots > 0:
            q = next((self._queues[p] for p in sorted(self._queues)
                      if self._queues[p]), None)
            if q is None:
                break
            need = self.reservation(q[0])
            if need > free_blocks:
                break                          # head-of-line blocks: no bypass
            req = q.popleft()
            admitted.append(req)
            free_slots -= 1
            free_blocks -= need
        return admitted
