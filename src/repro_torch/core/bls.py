"""Bounded-lag-synchronous (BLS) pipeline — the paper's contribution in the
form the paper built it: asynchronous collectives over a ring of receive
buffers (the port of ``repro/core/bls.py``).

Iteration ``j``

    1. runs ``stage_a`` on input ``x_j``  (paper: apply_emb)
    2. initiates ``collective`` on its payload (``all_to_all_single(...,
       async_op=True)`` into a fresh receive buffer)
    3. for ``j >= k``: waits on the exchange initiated at ``j-k`` and runs
       ``stage_b`` on its buffer (paper: wait() on the tail request, then
       the interaction and top MLP).

A drain loop (paper Listing 2's ``while unfinished > 0``) consumes the last
``k`` buffers in order.  The bound changes the schedule, never the values.

Memory: the reference's scan carries ``k`` ring slots.  Here ``k + 1``
receive buffers are live at the wait of iteration ``j``: the one just
initiated is in flight while ``k`` wait.  ``BLSStats`` keeps the
reference's accounting (``ring_bytes = k · slot_bytes``) so the two
packages report the same numbers for the same shapes.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable

import torch

Pytree = Any


@dataclasses.dataclass(frozen=True)
class BLSStats:
    """Static accounting of the pipeline (the paper's §V-F memory model)."""
    bound: int
    slot_bytes: int
    ring_bytes: int
    n_iterations: int


class Issued:
    """An initiated collective: ``wait()`` blocks (the stream, for NCCL)
    until ``recv`` is complete and returns it.  ``work`` is the
    ``torch.distributed`` handle, or None for a collective that completed
    when it was issued; ``keep`` holds the send buffer alive while the
    exchange is in flight."""

    def __init__(self, recv: Pytree, work=None, keep=None):
        self.recv, self._work, self._keep = recv, work, keep

    def wait(self) -> Pytree:
        if self._work is not None:
            self._work.wait()
            self._work = self._keep = None
        return self.recv


def _leaves(tree: Pytree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def tree_bytes(tree: Pytree) -> int:
    """Bytes of every tensor leaf (``meta`` tensors count their shape)."""
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def ring_slot_bytes(recv_shape: Pytree, side_shape: Pytree = ()) -> int:
    """Bytes ONE ring slot buffers for a (collective output, side data)
    pair, summed per leaf (pass ``device='meta'`` tensors for shapes)."""
    return tree_bytes(recv_shape) + tree_bytes(side_shape)


def bls_pipeline(
    stage_a: Callable[[Pytree], tuple[Pytree, Pytree]],
    collective: Callable[[Pytree], Issued],
    stage_b: Callable[[Pytree, Pytree], Pytree],
    xs: list,
    bound: int,
) -> tuple[list, BLSStats]:
    """Run ``stage_b(collective(a_payload).wait(), a_side)`` over the
    iterations ``xs`` with a lag of at most ``bound`` between initiating an
    exchange and consuming it.  Returns (outputs in iteration order,
    BLSStats)."""
    n = len(xs)
    k = int(bound)
    if k < 0:
        raise ValueError("bound must be >= 0")
    if k == 0:
        return reference_loop(stage_a, collective, stage_b, xs), \
            BLSStats(0, 0, 0, n)
    if n < k:
        raise ValueError(f"need at least bound={k} iterations, got {n}")
    ring: collections.deque = collections.deque()
    outs, slot_bytes = [], 0
    for x in xs:
        payload, side = stage_a(x)
        issued = collective(payload)
        if not ring:
            slot_bytes = ring_slot_bytes(issued.recv, side)
        ring.append((issued, side))
        if len(ring) > k:
            old, old_side = ring.popleft()
            outs.append(stage_b(old.wait(), old_side))
    while ring:
        old, old_side = ring.popleft()
        outs.append(stage_b(old.wait(), old_side))
    return outs, BLSStats(bound=k, slot_bytes=slot_bytes,
                          ring_bytes=k * slot_bytes, n_iterations=n)


def reference_loop(stage_a, collective, stage_b, xs) -> list:
    """The unpipelined oracle: strict per-iteration execution."""
    outs = []
    for x in xs:
        payload, side = stage_a(x)
        outs.append(stage_b(collective(payload).wait(), side))
    return outs


def memory_overhead_bytes(payload_shape, side_shape, bound: int) -> int:
    """Paper §V-F: O(k · (s·b·‖tables‖ + s² + b)), computed exactly from
    the shapes."""
    return bound * (tree_bytes(payload_shape) + tree_bytes(side_shape))
