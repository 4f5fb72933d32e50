"""Continuous-batching serve engine over a `CacheLayout` and a `Scheduler`
(port of `repro.launch.engine`, single device, fresh admissions and
recompute preemption).

    engine = ServeEngine(cfg, context_len=1056, max_batch=4,
                         prompt_capacity=1024, cache_layout="paged",
                         scheduler="paged")
    h1 = engine.submit([12, 7, 99, ...], max_new_tokens=16)
    h2 = engine.submit(prompt2, max_new_tokens=4)       # any prompt length
    for done in engine.run_to_completion():
      print(done.rid, done.tokens)
    print(engine.stats.summary())

- What is cached is the `CachePolicy` codec (`cfg.cache_policy`: exact,
  AQPIM pq, or a baseline: streamingllm, skvq, snapkv, pqcache).
- Where it lives is the `CacheLayout` (`cache_layout=`): `contiguous`
  capacity-sized slabs per slot, or `paged` fixed-size token blocks from a
  shared pool with per-request block tables.  With the `cuda` dispatch the
  paged layout decodes block-table-native through kernels K3 (pq), K4
  (exact) and K5 (exact, packed); the baselines take the dense gather
  program, and `streamingllm` frees the blocks that age out of its window.
- Who runs next is the `Scheduler` (`scheduler=`): `fifo`, `sjf`, or `paged`
  (admit-on-available-blocks, preempt-and-requeue on pool exhaustion: a
  preempted request is prefilled again from its prompt and, under greedy
  decoding, regenerates the same tokens).

Each admission runs a batch-1 prefill of the prompt right-padded to
`prompt_capacity`; per-request lengths let requests at different positions
share one decode step.  Greedy sampling.  `engine.stats` counts the lanes
that decoded nothing (occupancy, wasted slot-steps), admits and preempts.

Not ported here: the tiered layout and swap preemption (ROADMAP A9), the
prefix cache (A10), the virtual clock and SLO control (A11), fault
injection and snapshots (A12), and mesh sharding (A13).  Their constructor
arguments raise `NotImplementedError` when set, and so does a config that
asks for the prefix cache.  `cfg.host_blocks` is read by the tiered layout
only, in the reference too, so the other layouts ignore it.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import timing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache_registry
from repro_torch.launch import scheduler as scheduler_lib
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

# constructor arguments of the reference engine whose branches are not
# ported, with the ROADMAP item that ports each
_UNPORTED_ARGS = {
    "host_blocks": "A9", "prefix_cache": "A10", "prefix_cache_blocks": "A10",
    "clock": "A11", "slo_enforce": "A11", "fault_injector": "A12",
    "snapshot_dir": "A12", "shard_redundancy": "A12", "mesh": "A13",
    "mesh_model": "A13",
}


@dataclasses.dataclass
class RequestHandle:
  """One submitted generation request; `tokens` fills in as it decodes."""
  rid: int
  prompt: np.ndarray                 # (prompt_len,) int32
  max_new_tokens: int
  tokens: List[int] = dataclasses.field(default_factory=list)
  done: bool = False
  slot: Optional[int] = None
  admitted_step: Optional[int] = None
  finished_step: Optional[int] = None
  preempt_count: int = 0             # recompute preemptions (KV discarded)
  submitted_step: Optional[int] = None

  @property
  def prompt_len(self) -> int:
    return int(self.prompt.shape[0])


@dataclasses.dataclass
class EngineStats:
  """Per-run engine counters."""
  max_batch: int
  steps: int = 0                 # step() calls, including idle ones
  decode_steps: int = 0          # batched decode launches
  busy_slot_steps: int = 0       # slot-steps that advanced a live request
  wasted_slot_steps: int = 0     # slot-steps that decoded garbage (idle lane)
  admits: int = 0
  preempts: int = 0              # recompute preemptions (tokens regenerated)
  finished: int = 0
  blocks_reclaimed: int = 0      # ring-reuse frees (streamingllm's window)
  prefill_tokens: int = 0        # prompt tokens prefilled
  # wall clock per batched decode step (launch -> next-token sync); bounded
  # to the most recent window of samples
  decode_step_s: collections.deque = dataclasses.field(
      default_factory=lambda: collections.deque(maxlen=4096), repr=False)
  # queue depth sampled once per step(), and per-request waiting time
  # (submit -> first admit) in engine steps
  queue_depth_samples: collections.deque = dataclasses.field(
      default_factory=lambda: collections.deque(maxlen=4096), repr=False)
  queue_wait_steps: collections.deque = dataclasses.field(
      default_factory=lambda: collections.deque(maxlen=4096), repr=False)

  @property
  def occupancy(self) -> float:
    """Fraction of decode lanes that did useful work."""
    lanes = self.decode_steps * self.max_batch
    return self.busy_slot_steps / lanes if lanes else 0.0

  def decode_latency(self) -> dict:
    """Per-step decode latency percentiles (ms) over this run's samples,
    raw wall clock (drain a warm-up request and `reset_stats` first for
    steady-state numbers)."""
    return timing.latency_percentiles_ms(self.decode_step_s)

  def queue_gauges(self) -> dict:
    """Queue-pressure snapshot: current/mean/max depth and mean/max
    per-request waiting time (in engine steps)."""
    depth = list(self.queue_depth_samples)
    wait = list(self.queue_wait_steps)
    return dict(
        depth_now=int(depth[-1]) if depth else 0,
        depth_mean=round(float(np.mean(depth)), 3) if depth else 0.0,
        depth_max=int(max(depth)) if depth else 0,
        wait_steps_mean=round(float(np.mean(wait)), 3) if wait else 0.0,
        wait_steps_max=int(max(wait)) if wait else 0,
        depth_samples=len(depth), wait_samples=len(wait))

  def as_dict(self) -> dict:
    """Read-only snapshot; deque-valued sample windows are left out."""
    d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
         if not isinstance(getattr(self, f.name), collections.deque)}
    d["occupancy"] = round(self.occupancy, 4)
    d["decode_latency"] = self.decode_latency()
    d["queue"] = self.queue_gauges()
    return d

  def summary(self) -> str:
    s = (f"occupancy {100 * self.occupancy:.1f}% "
         f"({self.busy_slot_steps}/{self.decode_steps * self.max_batch} "
         f"slot-steps, {self.wasted_slot_steps} wasted) | "
         f"admits {self.admits}, preempts {self.preempts}, "
         f"finished {self.finished}, reclaimed {self.blocks_reclaimed} "
         f"blocks")
    lat = self.decode_latency()
    if lat["steps"]:
      s += (f" | decode step p50 {lat['p50_ms']:.2f} ms / "
            f"p99 {lat['p99_ms']:.2f} ms")
    return s


class ServeEngine:
  """Slot-based continuous batching over `Model.prefill` and the layout's
  decode step.

  The model is `model=` (built, with its weights), or is built here from
  `cfg` on `device` with `params=` (the reference's params pytree as numpy
  arrays, loaded through `params_from_numpy`) or random weights from
  `seed`.
  """

  def __init__(self, cfg: ModelConfig, *, context_len: int = 256,
               max_batch: int = 4, prompt_capacity: Optional[int] = None,
               params: Any = None, model: Optional[Model] = None,
               seed: int = 0, device="cuda",
               cache_layout: Optional[str] = None,
               scheduler: Optional[str] = None,
               block_size: Optional[int] = None,
               num_blocks: Optional[int] = None, **unported):
    for name, value in unported.items():
      if name not in _UNPORTED_ARGS:
        raise TypeError(f"ServeEngine got an unexpected keyword {name!r}")
      if value not in (None, False, "none"):
        raise NotImplementedError(
            f"ServeEngine({name}=...) is not ported to repro_torch yet "
            f"(ROADMAP {_UNPORTED_ARGS[name]})")
    if cfg.prefix_cache or cfg.prefix_cache_blocks is not None:
      raise NotImplementedError(
          "cfg.prefix_cache / cfg.prefix_cache_blocks: the prefix cache is "
          "not ported to repro_torch yet (ROADMAP A10)")
    if cfg.family != "dense" or cfg.frontend != "none":
      raise ValueError(
          f"ServeEngine serves the dense family without modal streams, got "
          f"{cfg.family!r} (frontend {cfg.frontend!r})")
    self.cfg = cfg
    self.context_len = context_len
    self.max_batch = max_batch
    self.prompt_capacity = prompt_capacity or max(context_len // 2,
                                                  cfg.pq_sink + cfg.pq_recent)
    if not self.prompt_capacity < context_len:
      raise ValueError(
          f"prompt_capacity {self.prompt_capacity} must be < context_len "
          f"{context_len}")
    if (cfg.resolved_cache_policy() == "pq"
        and self.prompt_capacity < cfg.pq_sink + cfg.pq_recent):
      raise ValueError(
          f"pq policy needs prompt_capacity >= sink+recent "
          f"({cfg.pq_sink}+{cfg.pq_recent}), got {self.prompt_capacity}")

    layout_name = cache_layout or cfg.cache_layout
    self.scheduler = scheduler_lib.make(scheduler or cfg.scheduler)
    layout_cls = cache_registry.get_layout(layout_name)
    if self.scheduler.preemptive and not layout_cls.pooled:
      raise ValueError(
          f"scheduler {self.scheduler.name!r} gates admission on the block "
          f"pool; it requires cache_layout='paged', got {layout_name!r}")

    if model is None:
      model = Model(cfg, context_len=context_len, device=device)
      if params is not None:
        params_from_numpy(model, params)
      else:
        model.init(torch.Generator(device=model.device).manual_seed(seed))
    elif model.context_len != context_len:
      raise ValueError(f"model context {model.context_len} != engine "
                       f"context_len {context_len}")
    self.model = model
    self.layout = cache_registry.make_layout(
        layout_name, model, max_batch, block_size=block_size,
        num_blocks=num_blocks)

    self.stats = EngineStats(max_batch=max_batch)
    self._lengths = np.zeros((max_batch,), np.int32)
    self._cur = np.zeros((max_batch,), np.int32)
    self._slots: List[Optional[RequestHandle]] = [None] * max_batch
    self._queue: collections.deque = collections.deque()
    self._next_rid = 0
    self._step_no = 0

  # -------------------------------------------------------------------------
  # public API
  # -------------------------------------------------------------------------

  def kv_bytes(self) -> dict:
    """Stats-json `kv_bytes` section: the codecs shaping KV storage plus
    what the layout's arrays occupy."""
    info = dict(spill_codec=self.cfg.spill_codec,
                kv_resident_codec=self.cfg.kv_resident_codec)
    info.update(self.layout.bytes(active_slots=self.active_count))
    return info

  def reset_stats(self) -> None:
    """Fresh counters (e.g. after a warm-up drain, so latency percentiles
    measure steady-state steps)."""
    self.stats = EngineStats(max_batch=self.max_batch)

  def submit(self, prompt: Sequence[int],
             max_new_tokens: int = 16) -> RequestHandle:
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if not 0 < prompt.shape[0] <= self.prompt_capacity:
      raise ValueError(
          f"prompt length {prompt.shape[0]} not in (0, {self.prompt_capacity}]")
    if max_new_tokens < 1:
      raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt.shape[0] + max_new_tokens > self.context_len:
      raise ValueError("prompt + max_new_tokens exceeds context capacity")
    if not self.layout.fits(prompt.shape[0] + max_new_tokens,
                            prompt.shape[0]):
      raise ValueError(
          f"request needs more KV blocks than the whole pool holds "
          f"({self.layout!r}); raise num_blocks or shorten the request")
    req = RequestHandle(rid=self._next_rid, prompt=prompt,
                        max_new_tokens=max_new_tokens,
                        submitted_step=self._step_no)
    self._next_rid += 1
    self._queue.append(req)
    return req

  @property
  def has_work(self) -> bool:
    return bool(self._queue) or any(r is not None for r in self._slots)

  @property
  def active_count(self) -> int:
    return sum(r is not None for r in self._slots)

  @property
  def active_requests(self) -> List[Tuple[int, RequestHandle]]:
    """(slot, request) pairs currently decoding: the scheduler's view."""
    return [(s, r) for s, r in enumerate(self._slots) if r is not None]

  def admissible(self, req: RequestHandle) -> bool:
    """Can this queued request be admitted right now?"""
    return self.layout.can_admit(req.prompt_len,
                                 req.prompt_len + req.max_new_tokens)

  def step(self) -> List[RequestHandle]:
    """Admit queued requests into free slots, run one batched decode step,
    and return the requests that finished this step."""
    self.stats.queue_depth_samples.append(len(self._queue))
    finished = self._admit()
    if self.active_count:
      # every active row grows by one token this step; secure its block
      # first (may preempt-and-requeue under the paged scheduler)
      self._ensure_blocks()
    if self.active_count == 0:
      self._step_no += 1
      self.stats.steps += 1
      return finished

    t0 = time.perf_counter()
    logits = self.layout.decode(self._cur, self._lengths)
    # the copy to the host waits for the device: the sample spans
    # launch -> sync
    next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
    self.stats.decode_step_s.append(time.perf_counter() - t0)
    self.stats.decode_steps += 1
    self.stats.busy_slot_steps += self.active_count
    self.stats.wasted_slot_steps += self.max_batch - self.active_count

    for slot, req in enumerate(self._slots):
      if req is None:
        continue
      # the token just fed (cur) is now cached at position lengths[slot]
      self._lengths[slot] += 1
      tok = int(next_tok[slot])
      req.tokens.append(tok)
      self._cur[slot] = tok
      if (len(req.tokens) >= req.max_new_tokens
          or int(self._lengths[slot]) + 1 >= self.context_len):
        finished.append(self._finish(slot, req))
      else:
        self.stats.blocks_reclaimed += self.layout.reclaim(
            slot, int(self._lengths[slot]))
    self._step_no += 1
    self.stats.steps += 1
    return finished

  def run_to_completion(self, max_steps: int = 10_000) -> List[RequestHandle]:
    """Drive `step()` until queue and slots drain; returns finish order."""
    done: List[RequestHandle] = []
    steps = 0
    while self.has_work:
      done.extend(self.step())
      steps += 1
      if steps > max_steps:
        raise RuntimeError(f"engine did not drain within {max_steps} steps")
    return done

  # -------------------------------------------------------------------------
  # internals
  # -------------------------------------------------------------------------

  def _admit(self) -> List[RequestHandle]:
    """Prefill scheduler-picked queued requests into free slots (the
    reference's `_admit_pass` for fresh requests)."""
    finished = []
    free_slots = [s for s, r in enumerate(self._slots) if r is None]
    while free_slots and self._queue:
      idx = self.scheduler.pick(self._queue, self)
      if idx is None:
        break
      req = self._queue[idx]
      if not self.admissible(req):
        break                       # wait for running requests to free blocks
      del self._queue[idx]
      slot = free_slots.pop(0)
      self.stats.queue_wait_steps.append(self._step_no - req.submitted_step)
      first = self._prefill_into(slot, req)
      req.slot = slot
      req.admitted_step = self._step_no
      req.tokens.append(first)
      self._slots[slot] = req
      self._lengths[slot] = req.prompt_len
      self._cur[slot] = first
      self.stats.admits += 1
      if len(req.tokens) >= req.max_new_tokens:
        finished.append(self._finish(slot, req))
        free_slots.insert(0, slot)
    return finished

  def _prefill_into(self, slot: int, req: RequestHandle) -> int:
    """Full prefill of the prompt, right-padded to `prompt_capacity`, into
    `slot`; returns the first greedy token."""
    dev = self.model.device
    padded = np.zeros((1, self.prompt_capacity), np.int64)
    padded[0, :req.prompt_len] = req.prompt
    logits, slot_cache = self.model.prefill(
        torch.from_numpy(padded).to(dev),
        torch.tensor([req.prompt_len], dtype=torch.int32, device=dev))
    self.layout.admit(slot, slot_cache, req.prompt_len)
    self.stats.prefill_tokens += req.prompt_len
    return int(torch.argmax(logits[0], dim=-1))

  def _ensure_blocks(self) -> None:
    """Grow every active slot's block table to hold this step's token,
    preempting (scheduler permitting) when the pool runs dry."""
    while True:
      growers = [(slot, self.layout.need_blocks(slot, int(ln) + 1))
                 for slot, ln in enumerate(self._lengths)
                 if self._slots[slot] is not None]
      total_need = sum(n for _, n in growers)
      if total_need <= self.layout.free_blocks:
        for slot, need in growers:
          if need and not self.layout.ensure(
              slot, int(self._lengths[slot]) + 1):
            raise AssertionError("pool accounting drifted during growth")
        return
      victim = self.scheduler.on_exhausted(self)
      if victim is None:
        raise RuntimeError(
            f"KV block pool exhausted (need {total_need}, free "
            f"{self.layout.free_blocks}) and scheduler "
            f"{self.scheduler.name!r} cannot preempt; use --scheduler paged "
            f"or a larger --num-blocks")
      self._preempt(victim)

  def _preempt(self, slot: int) -> None:
    """Recompute preemption: release the slot, requeue the request at the
    head; greedy decoding regenerates its tokens on re-admission."""
    req = self._slots[slot]
    req.tokens = []
    req.slot = None
    req.admitted_step = None
    req.preempt_count += 1
    self.layout.release(slot)
    self._slots[slot] = None
    self._lengths[slot] = 0
    self._cur[slot] = 0
    self._queue.appendleft(req)
    self.stats.preempts += 1

  def _finish(self, slot: int, req: RequestHandle) -> RequestHandle:
    req.done = True
    req.finished_step = self._step_no
    self.layout.release(slot)
    self._slots[slot] = None
    self._lengths[slot] = 0
    self._cur[slot] = 0
    self.stats.finished += 1
    return req
