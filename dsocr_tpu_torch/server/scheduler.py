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
  row, or one join_many for several), runs a decode chunk, harvests, and
  releases finished rows, resolving their futures.

With ``DSOCR_PAGED_KV=1`` the KV cache is a shared page pool
(engine.make_paged_slot_runner, runtime/paged.py): a join that finds too
few free pages while other rows are live waits for their release, as one
that runs out of device memory does.

Left out against the reference: the prefix cache, device-fault recovery,
load shedding, speculative chunk dispatch and streaming.

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
import logging
import os
import time
from typing import Any, List, Optional, Tuple

import torch

from ..core.params import DecodeOutcome, DecodeParameters, VisionSettings, normalize_text
from ..runtime.generate import clamp_new_tokens
from ..runtime.slots import NGRAM_MAX

logger = logging.getLogger("dsocr_torch.scheduler")

# a cold pipeline's first wave runs with nothing to overlap; a smaller one
# starts decode sooner
FIRST_WAVE = 4


@dataclasses.dataclass
class _SlotJob:
    prompt: str
    images: List[Any]
    vision: VisionSettings
    params: DecodeParameters
    future: asyncio.Future
    prompt_len: int = 0
    max_new: int = 0
    truncated: bool = False
    first: Optional[int] = None  # wave-level device selection, or None
    t_submit: float = 0.0


class ContinuousScheduler:
    def __init__(
        self,
        engine,
        tokenizer,
        n_slots: int = 8,
        max_len: int = 4096,
        chunk_steps: int = 32,
        prefill_batch: Optional[int] = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        # row KV blocks are padded to 128-token multiples at prefill
        self.max_len = max(128, (min(max_len, engine.max_seq_len) // 128) * 128)
        self.chunk_steps = chunk_steps
        self.prefill_batch = prefill_batch or max(2, n_slots // 2)
        self._ramped = False
        self._runner = None
        self._state = None
        self._rows: List[Optional[_SlotJob]] = [None] * n_slots
        self._deferred: List[Tuple[_SlotJob, dict]] = []
        self._loop = None
        self._new_loop_state()
        self.batch_sizes: List[int] = []  # occupancy per chunk
        self.ttft_samples: "collections.deque[float]" = collections.deque(maxlen=4096)

    def _new_loop_state(self) -> None:
        self.queue: asyncio.Queue = asyncio.Queue()
        self._ready_q: asyncio.Queue = asyncio.Queue(maxsize=max(2, self.prefill_batch))
        self._worker_task: Optional[asyncio.Task] = None
        self._prefill_task: Optional[asyncio.Task] = None
        self._inflight = 0

    # -- public API ---------------------------------------------------------

    async def submit(self, prompt: str, images: List[Any], vision: VisionSettings,
                     params: DecodeParameters) -> DecodeOutcome:
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
        job = _SlotJob(prompt, images, vision, params, loop.create_future())
        job.t_submit = time.perf_counter()
        self._inflight += 1
        await self.queue.put(job)
        self._ensure_workers()
        return await job.future

    # -- helpers ----------------------------------------------------------------

    def _ensure_workers(self) -> None:
        loop = asyncio.get_running_loop()
        if self._prefill_task is None:
            self._prefill_task = loop.create_task(self._prefill_worker())
        if self._worker_task is None:
            self._worker_task = loop.create_task(self._worker())

    def _ensure_state(self) -> None:
        if self._runner is not None:
            return
        if os.environ.get("DSOCR_PAGED_KV") == "1":
            # a shared page pool + per-row page tables: rows hold pages
            # for prompt + budget instead of a worst-case [max_len] row
            runner, cache = self.engine.make_paged_slot_runner(self.n_slots, self.max_len)
        else:
            runner = self.engine.make_slot_runner()
            cache = self.engine.new_slot_cache(self.n_slots, self.max_len)
        self._state = runner.init_state(cache, context_len=self.max_len)
        self._runner = runner

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
        todo = []
        for i, job in enumerate(jobs):
            try:
                self._validate_job(job)
                todo.append(i)
            except Exception as err:
                packets[i] = err
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
        if not self._ramped:
            limit = min(limit, FIRST_WAVE)
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
                try:
                    self._ensure_state()
                    packets = await loop.run_in_executor(None, self._prepare_jobs, jobs)
                except Exception as err:
                    logger.exception("prefill wave failed")
                    packets = [err] * len(jobs)
                for job, pre in zip(jobs, packets):
                    if not isinstance(pre, dict):
                        self._fail(job, pre or RuntimeError("prefill failed"))
                        continue
                    await self._ready_q.put((job, pre))  # backpressure when full
                    self._ensure_workers()  # the decode worker may have gone idle
        finally:
            self._prefill_task = None

    # -- admission ----------------------------------------------------------------

    def _record_ttft(self, job: _SlotJob) -> None:
        """Submit → the first token is selected and the row is live."""
        self.ttft_samples.append(time.perf_counter() - job.t_submit)

    async def _release_and_finalize(self, loop, row: int, job: _SlotJob, tokens: List[int]) -> None:
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
            _, finished, _ = await loop.run_in_executor(
                None, functools.partial(self._runner.join, self._state, row, pre,
                                        job.params, job.max_new, first=job.first)
            )
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
                _, finished, _ = await loop.run_in_executor(
                    None, self._runner.join_many, self._state, rows, [pre for _, pre in items],
                    [j.params for j in jobs], [j.max_new for j in jobs], [j.first for j in jobs],
                )
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
                self._state = await loop.run_in_executor(
                    None, self._runner.run_chunk, self.engine.params, self._state, self.chunk_steps
                )
                harvest = await loop.run_in_executor(None, self._runner.harvest, self._state)
                for row, job in enumerate(self._rows):
                    if job is not None and not harvest.active[row]:
                        self._rows[row] = None
                        await self._release_and_finalize(loop, row, job, harvest.generated(row))
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
