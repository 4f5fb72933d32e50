"""Pluggable request schedulers for the continuous-batching serve engine
(port of `repro.launch.scheduler`: `fifo`, `sjf` and `paged`).

    from repro_torch.launch import scheduler
    sched = scheduler.make("paged")

| key      | admit order                  | on block exhaustion            |
|----------|------------------------------|--------------------------------|
| `fifo`   | submission order             | error (cannot preempt)         |
| `sjf`    | shortest prompt first        | error (cannot preempt)         |
| `paged`  | first request whose prompt   | preempt-and-requeue the        |
|          | fits the free block pool     | youngest running request       |

Schedulers see the engine read-only: the queue of `RequestHandle`s, the
active slots, and the layout's block pool.  The engine performs the actual
prefill/admit/preempt; a scheduler only answers "which request next?" and
"who yields when the pool runs dry?".  The reference's `prefix`, `tiered`
and `slo` keys raise `NotImplementedError` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

_SCHEDULERS: Dict[str, type] = {}

_UNPORTED = {"tiered": "A9", "prefix": "A10", "slo": "A11"}


def register(name: str) -> Callable[[type], type]:
  def deco(cls: type) -> type:
    if name in _SCHEDULERS and _SCHEDULERS[name] is not cls:
      raise ValueError(f"scheduler {name!r} already registered")
    _SCHEDULERS[name] = cls
    cls.name = name
    return cls
  return deco


def get(name: str) -> type:
  if name in _UNPORTED:
    raise NotImplementedError(
        f"scheduler {name!r} is not ported to repro_torch yet (ROADMAP "
        f"{_UNPORTED[name]})")
  try:
    return _SCHEDULERS[name]
  except KeyError:
    raise KeyError(
        f"unknown scheduler {name!r}; available: {names()}") from None


def make(name: str):
  return get(name)()


def names() -> Tuple[str, ...]:
  return tuple(sorted(_SCHEDULERS))


class Scheduler:
  """Admission-order + preemption protocol driving `ServeEngine.step`."""
  name: str = "base"
  #: True if this scheduler gates admission on the layout's block pool and
  #: resolves exhaustion by preempting (requires a pooled layout).
  preemptive: bool = False

  def pick(self, queue: Sequence, engine) -> Optional[int]:
    """Index into `queue` of the next request to admit, or None to wait."""
    raise NotImplementedError

  def on_exhausted(self, engine) -> Optional[int]:
    """Block pool ran dry mid-decode: slot to preempt-and-requeue, or None
    if this scheduler cannot preempt (the engine then raises)."""
    del engine
    return None

  def __repr__(self) -> str:
    return f"{type(self).__name__}()"


@register("fifo")
class FIFOScheduler(Scheduler):
  """Strict submission order."""

  def pick(self, queue, engine):
    del engine
    return 0 if queue else None


@register("sjf")
class SJFScheduler(Scheduler):
  """Shortest-prompt-first: minimizes mean wait under mixed prompt lengths
  (prompt length as the job-size proxy)."""

  def pick(self, queue, engine):
    del engine
    if not queue:
      return None
    return min(range(len(queue)), key=lambda i: (queue[i].prompt_len,
                                                 queue[i].rid))


@register("paged")
class PagedScheduler(Scheduler):
  """Admit-on-available-blocks with preempt-and-requeue on exhaustion.

  Admission walks the queue in submission order and admits the first
  request whose prompt fits the free block pool.  When a decode step cannot
  grow every running request by a block, the youngest running request
  yields (it has the least work to redo under recompute preemption) and is
  requeued at the queue head.  Never preempts the last running request: a
  request that fits the pool alone (checked at submit) can always finish.
  """
  preemptive = True

  def pick(self, queue, engine):
    for i, req in enumerate(queue):
      if engine.admissible(req):
        return i
    return None

  def on_exhausted(self, engine):
    active = [(req.admitted_step, req.rid, slot)
              for slot, req in engine.active_requests]
    if len(active) <= 1:
      return None
    return max(active)[2]
