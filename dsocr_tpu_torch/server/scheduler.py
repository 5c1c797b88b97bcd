"""Continuous (slot-based) batching (dsocr_tpu/server/scheduler.py,
ContinuousScheduler only).

Two cooperative asyncio tasks pipeline the request stages over an
engine's slot surface (make_slot_runner, new_slot_cache, prefill_for_slot,
prefill_for_slots):

- the PREFILL worker takes waves of queued requests and runs vision +
  prompt prefill for the wave on an executor thread, then selects every
  packet's first token in one batched device call (should that fail, as
  one request's bad knobs make it, each join selects on the host and only
  the bad request's join fails, as in the reference);
- the DECODE worker admits ready packets into free slots (one join per
  row, or one join_many for several), runs decode chunks, harvests
  (streaming each row's tokens to its callback), and releases finished
  rows, resolving their futures.

With ``DSOCR_PAGED_KV=1`` the KV cache is a shared page pool
(engine.make_paged_slot_runner, runtime/paged.py): a join that finds too
few free pages while other rows are live waits for their release, as one
that runs out of device memory does.

The reference's serving features, at its defaults and under its switch
names:

- sizes: ``DSOCR_SLOTS`` (8 slots), ``DSOCR_SLOT_SEQ`` (4096 positions a
  row, rounded down to a multiple of 128), ``DSOCR_FIRST_WAVE`` (4: a
  cold pipeline's first prefill wave is smaller, so decode starts sooner;
  0 disables), a prefill wave of ``max(2, n_slots // 2)``;
- speculative chunk dispatch, ``DSOCR_PIPELINE_CHUNKS`` (on; "0"
  disables): chunk N+1 is queued before chunk N is harvested, from a
  packed snapshot the runner copies after chunk N (run_chunk_snap), when
  N+1 is sure to be useful: no packet waits for a slot, every slot is
  full or no prefill can complete, nobody streams, and no row can reach
  its budget within two chunks. ``speculated_chunks`` counts them;
- streaming: ``submit(..., stream_cb)`` gets ``stream_cb(n, tokens)``
  with the whole token list at every chunk boundary where it grew;
  chunks are ``stream_chunk_steps`` (16) long while a row streams;
- the prefix cache (server/prefix_cache.py), ``DSOCR_PREFIX_CACHE``
  (0: off): identical (prompt, images, vision) requests reuse one
  prefill packet, within a wave (an alias) and across waves (an LRU hit);
- load shedding, ``DSOCR_MAX_INFLIGHT`` (0: unbounded): a submit beyond
  the in-flight cap raises QueueDepthExceeded, with a Retry-After
  estimate; ``shed_requests`` counts them;
- ``DSOCR_ADMIT_CHUNK`` (0: off): shorter chunks while slots are free and
  a prefill wave is under way;
- device-fault recovery, ``DSOCR_SCHED_MAX_RECOVERIES`` (3): when a
  chunk or its harvest raises, the slot state is rebuilt over the same
  cache buffers (a paged runner first returns every row's pages,
  release_all_rows) and every in-flight request rejoins from its
  host-side record: a continuation prefill of its prompt and the tokens
  harvested so far (engine.prefill_for_slot(extra_tokens=...)), with the
  rest of its budget. ``recoveries`` counts them; more consecutive
  faults than the cap fail the in-flight requests. A streamed request
  that has emitted tokens and whose engine cannot continue fails loudly
  rather than restart. Recovery covers only errors that leave the CUDA
  context usable: a raised exception, torch.cuda.OutOfMemoryError. A
  sticky CUDA error (an illegal address, a launch failure: every later
  call on the context fails too) cannot be recovered in-process; it is
  re-raised and fails every request (core/device.py,
  is_sticky_cuda_error);
- ``DSOCR_SCHED_TRACE=1``: timestamped pipeline events on stdout.

Two faults of the reference are not carried over: a failed join or
join_many leaves the slot state as it was (runtime/slots.py), so the
per-row retry runs against valid state; and an admission that must pause (a join that
ran out of device memory while other rows are live) keeps every untried
packet queued, in the batched path as in the per-row path (a paged
join_many that finds too few pages raises before it takes any, so the
per-row retry admits the rows that fit and defers the rest).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import functools
import inspect
import logging
import os
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..core.benchmark import Timer
from ..core.device import is_sticky_cuda_error
from ..core.params import DecodeOutcome, DecodeParameters, VisionSettings, normalize_text
from ..runtime.generate import clamp_new_tokens
from ..runtime.slots import NGRAM_MAX
from .prefix_cache import PrefixCache, request_key

logger = logging.getLogger("dsocr_torch.scheduler")


class QueueDepthExceeded(RuntimeError):
    """Admission refused: the scheduler's in-flight cap is full. At a deep
    burst TTFT is queue wait, which no non-preemptive reordering shortens;
    bounding the accepted queue moves the wait upstream, where a client
    can retry or go elsewhere (a server answers 503 with Retry-After)."""

    def __init__(self, depth: int, cap: int, retry_after_s: float):
        super().__init__(f"serving queue full ({depth} in flight >= cap {cap}); "
                         f"retry after ~{retry_after_s:.0f}s")
        self.depth = depth
        self.cap = cap
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class _SlotJob:
    prompt: str
    images: List[Any]
    vision: VisionSettings
    params: DecodeParameters
    future: asyncio.Future
    stream_cb: Optional[Callable[[int, List[int]], None]] = None
    prompt_len: int = 0
    max_new: int = 0
    truncated: bool = False
    emitted: int = 0  # tokens the last harvest reported (and streamed)
    first: Optional[int] = None  # wave-level device selection, or None
    t_submit: float = 0.0
    # fault recovery: the tokens generated before the row rejoined as a
    # continuation, and every token generated as of the last harvest
    prefix_tokens: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _cacheable(pre: dict) -> dict:
    """A packet as the prefix cache keeps it: K/V and logits in storage of
    their own, not views that pin the whole wave's prefill cache."""
    return dict(pre, row_k=pre["row_k"].contiguous(), row_v=pre["row_v"].contiguous(),
                logits=pre["logits"].clone())


class ContinuousScheduler:
    supports_streaming = True

    def __init__(
        self,
        engine,
        tokenizer,
        n_slots: Optional[int] = None,
        max_len: Optional[int] = None,
        chunk_steps: int = 32,
        stream_chunk_steps: int = 16,
        prefill_batch: Optional[int] = None,
        prefix_cache: Optional[int] = None,
        max_inflight: Optional[int] = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.n_slots = n_slots or _env_int("DSOCR_SLOTS", 8)
        max_len = min(max_len or _env_int("DSOCR_SLOT_SEQ", 4096),
                      getattr(engine, "max_seq_len", 4096))
        # row KV blocks are padded to 128-token multiples at prefill
        self.max_len = max(128, (max_len // 128) * 128)
        self.chunk_steps = chunk_steps
        self.stream_chunk_steps = stream_chunk_steps
        self.prefill_batch = prefill_batch or max(2, self.n_slots // 2)
        self._first_wave = _env_int("DSOCR_FIRST_WAVE", 4)
        self._pipeline = os.environ.get("DSOCR_PIPELINE_CHUNKS", "1") != "0"
        self._admit_chunk = _env_int("DSOCR_ADMIT_CHUNK", 0)
        self._max_recoveries = _env_int("DSOCR_SCHED_MAX_RECOVERIES", 3)
        self._trace_on = os.environ.get("DSOCR_SCHED_TRACE") == "1"
        self._trace_t0: Optional[float] = None
        if prefix_cache is None:
            prefix_cache = _env_int("DSOCR_PREFIX_CACHE", 0)
        self.prefix_cache = PrefixCache(prefix_cache) if prefix_cache > 0 else None
        if max_inflight is None:
            max_inflight = _env_int("DSOCR_MAX_INFLIGHT", 0)
        self.max_inflight = max_inflight or None
        self._ramped = False
        self._runner = None
        self._cache = None
        self._state = None
        self._rows: List[Optional[_SlotJob]] = [None] * self.n_slots
        self._deferred: List[Tuple[_SlotJob, dict]] = []
        self._loop = None
        self._new_loop_state()
        self._consecutive_failures = 0
        # counters
        self.batch_sizes: List[int] = []  # occupancy per chunk
        self.ttft_samples: "collections.deque[float]" = collections.deque(maxlen=4096)
        self.speculated_chunks = 0
        self.recoveries = 0
        self.shed_requests = 0

    def _new_loop_state(self) -> None:
        self.queue: asyncio.Queue = asyncio.Queue()
        self._ready_q: asyncio.Queue = asyncio.Queue(maxsize=max(2, self.prefill_batch))
        self._worker_task: Optional[asyncio.Task] = None
        self._prefill_task: Optional[asyncio.Task] = None
        self._inflight = 0

    # -- public API ---------------------------------------------------------

    async def submit(self, prompt: str, images: List[Any], vision: VisionSettings,
                     params: DecodeParameters,
                     stream_cb: Optional[Callable[[int, List[int]], None]] = None) -> DecodeOutcome:
        """Serve one request. ``stream_cb(n, tokens)``, if given, gets the
        whole token list so far at every chunk boundary where it grew.
        Raises QueueDepthExceeded when the in-flight cap is full."""
        loop = asyncio.get_running_loop()
        if self._loop is not loop:
            # a fresh event loop: queues and tasks of the old one are dead
            self._new_loop_state()
            if self._state is not None:
                for row, job in enumerate(self._rows):
                    if job is not None:
                        self._runner.release(self._state, row)
            self._rows = [None] * self.n_slots
            self._deferred = []
            self._loop = loop
        if self.max_inflight and self._inflight >= self.max_inflight:
            self.shed_requests += 1
            # Retry-After: the recent TTFT pace, at least a few seconds
            recent = list(self.ttft_samples)[-self.n_slots:]
            pace = sum(recent) / len(recent) if recent else 5.0
            raise QueueDepthExceeded(self._inflight, self.max_inflight, max(2.0, pace))
        job = _SlotJob(prompt, images, vision, params, loop.create_future(), stream_cb)
        job.t_submit = time.perf_counter()
        self._inflight += 1
        await self.queue.put(job)
        self._ensure_workers()
        return await job.future

    async def close(self) -> None:
        """Wait until every request this scheduler holds has finished and
        its worker tasks have ended, then drop the engine, the runner, the
        slot cache, the slot state and the prefix cache's packets (a server
        swapping models frees them before it loads the next engine)."""
        while self._inflight or self._worker_task is not None or self._prefill_task is not None:
            await asyncio.sleep(0.01)
        self.engine = self.prefix_cache = None
        self._runner = self._cache = self._state = None
        self._rows = [None] * self.n_slots
        self._deferred = []

    # -- helpers ----------------------------------------------------------------

    def _trace(self, event: str, **fields) -> None:
        """DSOCR_SCHED_TRACE=1: one timestamped pipeline event. Stage timers
        read wall time inside threads that share the card, so only the
        order of events shows where overlap is lost."""
        if not self._trace_on:
            return
        now = time.perf_counter()
        if self._trace_t0 is None:
            self._trace_t0 = now
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[sched {now - self._trace_t0:8.3f}] {event} {kv}", flush=True)

    def _ensure_workers(self) -> None:
        loop = asyncio.get_running_loop()
        if self._prefill_task is None:
            self._prefill_task = loop.create_task(self._prefill_worker())
        if self._worker_task is None:
            self._worker_task = loop.create_task(self._worker())

    def _ensure_state(self) -> None:
        """The runner and its cache at first use; the slot state over that
        cache whenever there is none (at first use and after a recovery)."""
        if self._runner is None:
            if os.environ.get("DSOCR_PAGED_KV") == "1":
                # a shared page pool + per-row page tables: rows hold pages
                # for prompt + budget instead of a worst-case [max_len] row
                self._runner, self._cache = self.engine.make_paged_slot_runner(
                    self.n_slots, self.max_len)
            else:
                self._runner = self.engine.make_slot_runner()
                self._cache = self.engine.new_slot_cache(self.n_slots, self.max_len)
            self._state = None
        if self._state is None:
            self._state = self._runner.init_state(self._cache, context_len=self.max_len)

    def _free_rows(self) -> List[int]:
        return [r for r, job in enumerate(self._rows) if job is None]

    def _fail(self, job: _SlotJob, err: BaseException) -> None:
        self._inflight -= 1
        if not job.future.done():
            job.future.set_exception(err)

    def _finalize(self, job: _SlotJob, tokens: List[int]) -> None:
        self._inflight -= 1
        if not job.future.done():
            text = normalize_text(self.tokenizer.decode(tokens, skip_special_tokens=True))
            job.future.set_result(DecodeOutcome(
                text=text, prompt_tokens=job.prompt_len, response_tokens=len(tokens),
                generated_tokens=tokens, truncated=job.truncated,
            ))

    def _finish_prepare(self, job: _SlotJob, pre: dict) -> dict:
        job.prompt_len = len(pre["prompt_ids"])
        job.max_new = clamp_new_tokens(job.prompt_len, job.params.max_new_tokens, self.max_len)
        job.truncated = job.max_new < job.params.max_new_tokens
        return pre

    def _validate_job(self, job: _SlotJob) -> None:
        """Raise for params the slot runtime cannot honor exactly: the
        engine's own refusals first (GLM serves greedy only), then an
        n-gram window past the runtime's."""
        validate = getattr(self.engine, "validate_slot_params", None)
        if validate is not None:
            validate(job.params)
        ngram = job.params.no_repeat_ngram_size
        if ngram and ngram > NGRAM_MAX:
            raise ValueError(
                f"no_repeat_ngram_size={ngram} exceeds the slot runtime limit ({NGRAM_MAX})"
            )

    # -- prefill ------------------------------------------------------------------

    def _prepare_jobs(self, jobs: List[_SlotJob]) -> list:
        """Blocking (executor thread): one packet or the failure per job.
        Futures are resolved on the loop thread, never here."""
        packets: list = [None] * len(jobs)
        keys: List[Any] = [None] * len(jobs)
        todo = []
        for i, job in enumerate(jobs):
            try:
                self._validate_job(job)
                if self.prefix_cache is not None:
                    # inside the try: an image that cannot be read fails
                    # its own job, not the wave
                    keys[i] = request_key(job.prompt, job.images, job.vision)
            except Exception as err:
                packets[i] = err
                continue
            if keys[i] is not None:
                hit = self.prefix_cache.get(keys[i])
                if hit is not None:
                    with Timer("slot.prefix_hit"):
                        packets[i] = self._finish_prepare(job, hit)
                    continue
                # the same request earlier in this wave: alias its packet
                first = next((j for j in todo if keys[j] == keys[i]), None)
                if first is not None:
                    self.prefix_cache.record_alias_hit()
                    keys[i] = ("alias", first)
                    continue
            todo.append(i)
        if len(todo) > 1:
            try:
                pres = self.engine.prefill_for_slots(
                    self.tokenizer, [(jobs[i].prompt, jobs[i].images, jobs[i].vision) for i in todo]
                )
                for i, pre in zip(todo, pres):
                    packets[i] = self._finish_prepare(jobs[i], pre)
            except Exception:
                logger.warning("batched prefill of %d jobs failed; retrying per request",
                               len(todo), exc_info=True)
        for i in todo:
            if packets[i] is None:
                try:
                    pre = self.engine.prefill_for_slot(
                        self.tokenizer, jobs[i].prompt, jobs[i].images, jobs[i].vision
                    )
                    packets[i] = self._finish_prepare(jobs[i], pre)
                except Exception as err:
                    packets[i] = err
        if self.prefix_cache is not None:
            for i in todo:
                if isinstance(packets[i], dict):
                    self.prefix_cache.put(keys[i], _cacheable(packets[i]))
            for i, key in enumerate(keys):
                if isinstance(key, tuple):  # a wave-local alias
                    src = packets[key[1]]
                    packets[i] = self._finish_prepare(jobs[i], src) if isinstance(src, dict) else src
        # the firsts ride on the jobs: a packet shared through the prefix
        # cache or an alias still selects with each request's own params
        ok = [i for i, p in enumerate(packets) if isinstance(p, dict)]
        if ok:
            try:
                firsts = self._runner.select_first_tokens(
                    [packets[i] for i in ok], [jobs[i].params for i in ok]
                )
                for i, tok in zip(ok, firsts):
                    jobs[i].first = tok
            except Exception:
                # one request's knobs can fail the wave's selection: each
                # join then selects on the host, and only a bad row fails
                logger.warning("wave first-token selection failed; join will select host-side",
                               exc_info=True)
        return packets

    def _grab_wave(self) -> List[_SlotJob]:
        limit = self.prefill_batch
        if not self._ramped and self._first_wave:
            limit = min(limit, self._first_wave)
        jobs: List[_SlotJob] = []
        while len(jobs) < limit:
            try:
                jobs.append(self.queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        self._ramped = self._ramped or bool(jobs)
        return jobs

    async def _prefill_worker(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                jobs = self._grab_wave()
                if not jobs:
                    return
                self._trace("wave_grab", n=len(jobs))
                try:
                    self._ensure_state()
                    packets = await loop.run_in_executor(None, self._prepare_jobs, jobs)
                except Exception as err:
                    logger.exception("prefill wave failed")
                    packets = [err] * len(jobs)
                self._trace("wave_prepared", n=len(jobs))
                for job, pre in zip(jobs, packets):
                    if not isinstance(pre, dict):
                        self._fail(job, pre or RuntimeError("prefill failed"))
                        continue
                    await self._ready_q.put((job, pre))  # backpressure when full
                    self._trace("packet_put", qsize=self._ready_q.qsize())
                    self._ensure_workers()  # the decode worker may have gone idle
        finally:
            self._prefill_task = None

    # -- admission ----------------------------------------------------------------

    def _record_ttft(self, job: _SlotJob) -> None:
        """Submit → the first token is selected and the row is live."""
        self.ttft_samples.append(time.perf_counter() - job.t_submit)

    def _join(self, row: int, job: _SlotJob, pre: dict, budget: Optional[int] = None) -> bool:
        """Blocking: insert a packet into `row`; `budget` overrides the
        row's appends (a continuation after a fault). → finished."""
        self._trace("join", row=row)
        with Timer("slot.join"):
            _, finished, _ = self._runner.join(
                self._state, row, pre, job.params, job.max_new if budget is None else budget,
                first=job.first)
        return finished

    async def _release_and_finalize(self, loop, row: int, job: _SlotJob, tokens: List[int]) -> None:
        """Release the row, then resolve the future: once the last future
        resolves, asyncio.run may close the loop before a release queued
        after it runs (a paged row's pages would leak)."""
        self._state = await loop.run_in_executor(None, self._runner.release, self._state, row)
        self._finalize(job, tokens)

    async def _admitted(self, loop, row: int, job: _SlotJob, finished: bool) -> None:
        self._record_ttft(job)
        if finished:  # EOS as the first token, or no budget
            await self._release_and_finalize(loop, row, job, [])
        else:
            self._rows[row] = job

    async def _admit_one(self, loop, row: int, job: _SlotJob, pre: dict) -> bool:
        """Admit one packet into `row`. False means admission must pause:
        the join ran out of device memory, or of pool pages, while other
        rows are live (their release will free it), and the packet was
        re-deferred. With no row live, nothing will free it: the request
        fails."""
        try:
            finished = await loop.run_in_executor(None, self._join, row, job, pre)
        except (torch.cuda.OutOfMemoryError, MemoryError) as err:
            if any(j is not None for j in self._rows):
                self._deferred.append((job, pre))
                return False
            self._fail(job, err)
            return True
        except Exception as err:
            self._fail(job, err)
            return True
        await self._admitted(loop, row, job, finished)
        return True

    def _join_many(self, rows: List[int], jobs: List[_SlotJob], pres: List[dict]) -> List[bool]:
        self._trace("join_many", rows=len(rows))
        with Timer("slot.join"):
            _, finished, _ = self._runner.join_many(
                self._state, rows, pres, [j.params for j in jobs], [j.max_new for j in jobs],
                [j.first for j in jobs])
        return finished

    async def _admit_ready(self, loop) -> None:
        free = self._free_rows()
        items: List[Tuple[_SlotJob, dict]] = []
        while len(items) < len(free):
            if self._deferred:
                items.append(self._deferred.pop(0))
                continue
            try:
                items.append(self._ready_q.get_nowait())
            except asyncio.QueueEmpty:
                break
        if len(items) > 1:
            rows = free[: len(items)]
            jobs = [job for job, _ in items]
            try:
                finished = await loop.run_in_executor(
                    None, self._join_many, rows, jobs, [pre for _, pre in items])
            except MemoryError as err:
                # too few pool pages for every row: the per-row joins below
                # admit the rows that fit and defer the rest
                logger.info("join of %d rows: %s; admitting per row", len(rows), err)
            except Exception:
                # join_many raises before touching the state, so each row
                # can be retried alone: only the bad packet fails
                logger.warning("join of %d rows failed; retrying per row", len(rows), exc_info=True)
            else:
                for row, job, fin in zip(rows, jobs, finished):
                    await self._admitted(loop, row, job, fin)
                return
        for i, ((job, pre), row) in enumerate(zip(items, free)):
            if not await self._admit_one(loop, row, job, pre):
                # paused: the untried packets stay queued, in order
                self._deferred.extend(items[i + 1 :])
                return

    # -- decode ---------------------------------------------------------------------

    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._ensure_state()
                await self._admit_ready(loop)
                active = [j for j in self._rows if j is not None]
                if not active:
                    if self._inflight == 0:
                        self._ramped = False  # the next burst is cold again
                        return
                    if self._ready_q.empty() and not self._deferred:
                        # prefills in flight: wait for a packet (the timeout
                        # re-checks _inflight in case every prefill failed)
                        try:
                            item = await asyncio.wait_for(self._ready_q.get(), timeout=0.25)
                        except asyncio.TimeoutError:
                            continue
                        self._deferred.insert(0, item)
                    continue
                self.batch_sizes.append(len(active))
                self._trace("chunk_start", occ=len(active))
                streaming = any(j.stream_cb is not None for j in active)
                chunk = self.stream_chunk_steps if streaming else self.chunk_steps
                if self._admit_chunk and self._free_rows() and self._prefill_task is not None:
                    # a packet finishing prefill mid-chunk waits less
                    chunk = min(chunk, self._admit_chunk)
                try:
                    await self._run_chunks_and_harvest(loop, active, chunk)
                except Exception as err:
                    if is_sticky_cuda_error(err) or not await self._recover_device_failure(loop, err):
                        raise
        except Exception as err:
            # never strand a future: fail every row and every queued packet
            for row, job in enumerate(self._rows):
                if job is not None:
                    self._fail(job, err)
                    self._rows[row] = None
            while not self._ready_q.empty():
                self._fail(self._ready_q.get_nowait()[0], err)
            for job, _ in self._deferred:
                self._fail(job, err)
            self._deferred = []
            raise
        finally:
            self._worker_task = None

    def _may_speculate(self, active: List[_SlotJob], chunk: int) -> bool:
        """Is chunk N+1 sure to be useful before chunk N is harvested? No
        packet waits for a slot; every slot is full, or no prefill can
        complete (a packet arriving mid-speculation would wait two chunks);
        nobody streams (their deltas would go stale); no row can reach
        its budget within two chunks (rows that end on EOS idle masked for
        one chunk)."""
        return (
            self._pipeline
            and self._ready_q.empty()
            and not self._deferred
            and (not self._free_rows() or (self.queue.empty() and self._prefill_task is None))
            and all(j.stream_cb is None for j in active)
            and all(j.emitted + 2 * chunk <= j.max_new for j in active)
        )

    def _chunk_snap(self, chunk: int):
        with Timer("slot.decode_chunk"):
            self._state, snap = self._runner.run_chunk_snap(self.engine.params, self._state, chunk)
        return snap

    async def _run_chunks_and_harvest(self, loop, active: List[_SlotJob], chunk: int) -> None:
        snaps = [await loop.run_in_executor(None, self._chunk_snap, chunk)]
        if self._may_speculate(active, chunk):
            self.batch_sizes.append(len(active))
            self.speculated_chunks += 1
            snaps.append(await loop.run_in_executor(None, self._chunk_snap, chunk))
        for snap in snaps:
            harvest_t = Timer("slot.harvest")
            harvest = await loop.run_in_executor(None, self._runner.harvest_from_snap, snap)
            harvest_t.finish(rows=len(active))
            self._trace("harvest_done", occ=len(active))
            self._consecutive_failures = 0
            await self._process_harvest(loop, harvest)

    async def _process_harvest(self, loop, harvest) -> None:
        for row, job in enumerate(self._rows):
            if job is None:
                continue
            tokens = job.prefix_tokens + harvest.generated(row)
            job.generated = tokens  # the host-side record recovery rejoins from
            if job.stream_cb is not None and len(tokens) > job.emitted:
                try:
                    job.stream_cb(len(tokens), tokens)
                except Exception:
                    logger.warning("stream callback failed", exc_info=True)
            job.emitted = len(tokens)
            if not harvest.active[row]:
                self._rows[row] = None
                with Timer("slot.release"):
                    await self._release_and_finalize(loop, row, job, tokens)

    # -- device-fault recovery ----------------------------------------------------------

    def _supports_continuation(self) -> bool:
        try:
            return "extra_tokens" in inspect.signature(self.engine.prefill_for_slot).parameters
        except (TypeError, ValueError):
            return False

    async def _recover_device_failure(self, loop, err: Exception) -> bool:
        """Rebuild the slot state after a failed chunk or harvest and rejoin
        every in-flight request from its host-side record (the module
        docstring). Only a request whose own re-prefill or join fails is
        failed. False: no recovery (too many consecutive faults, or the
        state could not be rebuilt); the caller re-raises."""
        self._consecutive_failures += 1
        inflight = [job for job in self._rows if job is not None]
        self._rows = [None] * self.n_slots
        if self._consecutive_failures > self._max_recoveries:
            logger.error("device fault persisted across %d recoveries; giving up",
                         self._consecutive_failures - 1)
            for job in inflight:
                self._fail(job, err)
            # the next request starts from a new runner and cache
            self._state = self._runner = self._cache = None
            self._consecutive_failures = 0
            return False
        logger.warning("decode chunk failed (%s: %s); rebuilding the slot state and rejoining "
                       "%d rows", type(err).__name__, err, len(inflight))
        self._trace("recovery", rows=len(inflight))
        self.recoveries += 1
        self._state = None
        release_all = getattr(self._runner, "release_all_rows", None)
        if release_all is not None:  # a paged runner: the lost rows' pages
            release_all()
        try:
            self._ensure_state()
        except Exception:
            logger.exception("slot state rebuild failed")
            for job in inflight:
                self._fail(job, err)
            return False
        continuation = self._supports_continuation()
        for job in inflight:
            prefix = list(job.generated)
            remaining = job.max_new - len(prefix)
            if remaining <= 0:  # the budget ran out at the last harvest
                self._finalize(job, prefix)
                continue
            if not continuation:
                if job.stream_cb is not None and job.emitted > 0:
                    # a restart would stream a list that does not extend
                    # what the client already has
                    self._fail(job, RuntimeError(
                        "device fault interrupted a streamed request and this engine cannot "
                        "resume from the generated prefix (no continuation prefill)"))
                    continue
                # restart: greedy regenerates the same tokens
                prefix, remaining = [], job.max_new
            extra = {"extra_tokens": prefix} if prefix else {}
            try:
                pre = await loop.run_in_executor(None, functools.partial(
                    self.engine.prefill_for_slot, self.tokenizer, job.prompt, job.images, job.vision,
                    **extra))
            except Exception as err2:
                self._fail(job, err2)
                continue
            job.prefix_tokens = prefix
            job.emitted = len(prefix)
            job.first = None  # selected from the new packet's logits
            row = self._free_rows()[0]
            try:
                finished = await loop.run_in_executor(None, self._join, row, job, pre, remaining)
            except Exception as err2:
                self._fail(job, err2)
                continue
            if finished:
                await self._release_and_finalize(loop, row, job, prefix)
            else:
                self._rows[row] = job
        return True
