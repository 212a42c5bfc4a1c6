"""Pure request queue with admission deadlines (FIFO within priority).

Counterpart of ``repro/serve/queue.py`` (a copy: pure Python).

The queue is immutable data plus pure functions — the same def/state
discipline as ``AgentDef``/``AgentState``. Every transition takes an
explicit ``now`` (from ``serve.clock``), returns a new state, and
reports what happened, so admission/expiry decisions are unit-testable
without an engine, a device, or a wall clock:

    q = queue_init()
    q = queue_push(q, requests)
    q, expired = queue_expire(q, now)      # past-deadline drops
    q, admitted = queue_pop(q, k, now)     # k best by (priority, seq)

Ordering is FIFO within priority: lower ``priority`` values drain
first, ties broken by submission order (a monotone ``seq`` stamped at
push). ``queue_pop`` never returns a request whose deadline has passed
— callers run ``queue_expire`` first, and pop re-checks as a belt.
Evicted in-flight requests re-enter with their *original* seq
(``queue_requeue``), so evict-then-readmit reproduces the schedule the
request would have had — the idempotence property ``tests/test_serve.py``
pins.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Tuple


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One serving request with an absolute admission deadline.

    ``arrival_s``/``deadline_s`` are instants on the serving clock
    (seconds); a request not *scheduled* strictly before ``deadline_s``
    is expired, never served. ``priority`` orders admission (lower =
    more urgent); ``prompt_len``/``max_new`` size the synthetic decode
    payload.
    """
    rid: int
    arrival_s: float
    deadline_s: float
    priority: int = 0
    prompt_len: int = 8
    max_new: int = 8


class QueueEntry(NamedTuple):
    """A queued request plus its submission-order stamp."""
    seq: int
    req: ServeRequest


class QueueState(NamedTuple):
    """Immutable queue state: pending entries + the next seq stamp.

    ``pending`` preserves push order; ordering policy is applied at pop
    time (stable sort by (priority, seq)), so requeued entries slot back
    into exactly the position their original seq gives them.
    """
    pending: Tuple[QueueEntry, ...]
    next_seq: int


def queue_init() -> QueueState:
    return QueueState(pending=(), next_seq=0)


def queue_depth(q: QueueState) -> int:
    return len(q.pending)


def queue_push(q: QueueState,
               requests: Iterable[ServeRequest]) -> QueueState:
    """Append requests in iteration order, stamping each with a seq."""
    entries = list(q.pending)
    seq = q.next_seq
    for req in requests:
        entries.append(QueueEntry(seq=seq, req=req))
        seq += 1
    return QueueState(pending=tuple(entries), next_seq=seq)


def queue_requeue(q: QueueState,
                  entries: Iterable[QueueEntry]) -> QueueState:
    """Return evicted entries to the queue with their original seqs.

    Does not advance ``next_seq`` — the entries were already stamped, so
    a subsequent pop orders them exactly as if they had never left.
    """
    return q._replace(pending=tuple(q.pending) + tuple(entries))


def _order(entry: QueueEntry):
    return (entry.req.priority, entry.seq)


def queue_expire(q: QueueState, now: float):
    """Drop every pending request whose deadline has passed.

    A request with ``deadline_s <= now`` can no longer be scheduled in
    time, so it expires (is never admitted). Returns
    (new queue, expired entries in (priority, seq) order).
    """
    keep, expired = [], []
    for entry in q.pending:
        (expired if entry.req.deadline_s <= now else keep).append(entry)
    expired.sort(key=_order)
    return q._replace(pending=tuple(keep)), tuple(expired)


def queue_pop(q: QueueState, k: int, now: float):
    """Admit up to ``k`` schedulable requests, FIFO within priority.

    Past-deadline entries are skipped (left for ``queue_expire``), so a
    pop can never admit an already-dead request even if the caller
    forgot to expire first. Returns (new queue, admitted entries in
    admission order).
    """
    if k <= 0:
        return q, ()
    eligible = sorted((e for e in q.pending if e.req.deadline_s > now),
                      key=_order)
    admitted = tuple(eligible[:k])
    taken = {e.seq for e in admitted}
    keep = tuple(e for e in q.pending if e.seq not in taken)
    return q._replace(pending=keep), admitted
