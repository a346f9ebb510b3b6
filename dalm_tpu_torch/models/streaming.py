"""Streaming (online) serving over the decode engine (counterpart of ``dalm_tpu/models/streaming.py``).

``DecodeEngine.generate`` drains a workload known up front. Here requests
arrive over time: one scheduler thread owns the engine and runs its
scheduling rounds without end, and a submission from any thread joins the
queue and is admitted into a freed slot mid-flight.

Tokens stream out as they are made: each :class:`StreamHandle` carries a
thread-safe token queue (:meth:`StreamHandle.tokens`) and a
``concurrent.futures.Future`` of the whole token list, so
``asyncio.wrap_future(handle.future)`` awaits it. Usage::

    eng = DecodeEngine(decoder, num_slots=32, max_prompt_len=256, max_new_tokens=64)
    with StreamingEngine(eng) as srv:
        h = srv.submit(prompt_ids, prompt_mask)   # returns at once
        for tok in h.tokens():                     # as they decode
            ...
        full = h.result(timeout=60)

Every request's tokens are the engine's for its prompt, whenever it arrived,
whichever slot served it and whatever else was in flight. The scheduler
drives the engine's own steps (``_admit_rows``, ``_decode_chunk``,
``_verify``) on its thread, after making the engine's device current there.
If it fails, every open handle fails with its exception, later submissions
raise, and the exception is raised again on the thread.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Iterator, List, Optional

import numpy as np
import torch

from dalm_tpu_torch.models.decode_engine import DecodeEngine

_SENTINEL = object()


class StreamHandle:
    """One submitted request: stream its tokens, or wait for all of them."""

    def __init__(self, budget: int):
        self.budget = budget
        self.future: Future = Future()
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._tokens: List[int] = []
        self._cancelled = threading.Event()
        # latency stamps (time.monotonic() s), set by submit and the scheduler
        self.t_submit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        # speculative serving: the verify passes this request took
        self.spec_rounds: int = 0

    # ---- consumer side ---------------------------------------------------
    def tokens(self) -> Iterator[int]:
        """Yield tokens as the scheduler produces them (a blocking iterator)."""
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Wait for the request to finish; its whole token list."""
        return self.future.result(timeout)

    def cancel(self) -> None:
        """A request not yet admitted is dropped (its result is []); a running one stops at the next harvest
        with the tokens it has."""
        self._cancelled.set()

    @property
    def done(self) -> bool:
        return self.future.done()

    # ---- scheduler side (the scheduler thread only) -------------------------
    def _emit(self, tok: int) -> None:
        if self.t_first_token is None:
            self.t_first_token = time.monotonic()
        self._tokens.append(tok)
        self._queue.put(tok)

    def _finish(self) -> None:
        self.t_done = time.monotonic()
        if not self.future.done():
            self.future.set_result(self._tokens)
        self._queue.put(_SENTINEL)

    def _fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)
        self._queue.put(_SENTINEL)


class StreamingEngine:
    """A thread-scheduled online server over one :class:`DecodeEngine`.

    Nothing else may use the engine while the server runs: the scheduler owns
    ``engine.state``. ``submit`` is thread-safe. A ``speculative_gamma``
    engine runs synchronous verify rounds (``_speculative_scheduler_loop``):
    the host drafts from each request's tokens, the device verifies, and 1 to
    G + 1 tokens a slot stream out a round."""

    def __init__(self, engine: DecodeEngine, idle_poll_s: float = 0.02):
        self.engine = engine
        self._inbox: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self._idle_poll = idle_poll_s
        self._crashed: Optional[BaseException] = None
        self._live_handles: List[StreamHandle] = []  # the scheduler thread's
        self._n_submitted = 0  # request ids (the sampling keys)
        self._submit_lock = threading.Lock()
        self._slot_req: List[Optional[StreamHandle]] = [None] * engine.num_slots  # the scheduler thread's

    @property
    def free_slots(self) -> int:
        """Decode slots that hold no request (read from any thread; the scheduler may change it at once)."""
        return sum(h is None for h in self._slot_req)

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "StreamingEngine":
        if self._thread is not None:
            raise RuntimeError("StreamingEngine already started")
        self._thread = threading.Thread(target=self._run, daemon=True, name="decode-scheduler")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the scheduler: ``drain=True`` finishes the accepted work first; ``drain=False`` ends pending and
        running requests with the tokens they have."""
        self._drain = drain
        self._stop.set()
        self._inbox.put(None)  # wake an idle scheduler
        if self._thread is not None:
            self._thread.join(timeout)
        with self._submit_lock:
            # submissions that raced past the stop check before the scheduler exited must not hang
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[0]._finish()

    def __enter__(self) -> "StreamingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # ---- submission ---------------------------------------------------------
    def submit(self, input_ids: np.ndarray, attention_mask: np.ndarray,
               budget: Optional[int] = None) -> StreamHandle:
        """Queue one left-padded (P,) or (1, P) prompt and return at once; decoding starts when a slot frees.
        ``budget`` caps its new tokens (at most the engine's ``max_new_tokens``; 0 finishes it at once)."""
        if self._stop.is_set():
            raise RuntimeError("StreamingEngine is stopping")
        if self._crashed is not None:
            raise RuntimeError("scheduler crashed") from self._crashed
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        mask = np.asarray(attention_mask, np.int64).reshape(-1)
        P = self.engine.P
        if ids.shape != (P,) or mask.shape != (P,):
            raise ValueError(f"a prompt must be left-padded to max_prompt_len={P}; got ids {ids.shape}, "
                             f"mask {mask.shape}")
        cap = self.engine.max_new if budget is None else min(int(budget), self.engine.max_new)
        handle = StreamHandle(cap)
        handle.t_submit = time.monotonic()
        with self._submit_lock:
            # one lock over the request id (unique: the sampling keys derive from it) and over the stop check
            # with the enqueue (a submit racing stop() must not land in a dead inbox)
            if self._stop.is_set():
                raise RuntimeError("StreamingEngine is stopping")
            handle.req_index = self._n_submitted
            self._n_submitted += 1
            if cap <= 0:
                handle._finish()
                return handle
            self._inbox.put((handle, ids, mask))
        return handle

    # ---- scheduler ---------------------------------------------------------
    def _run(self) -> None:
        try:
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            with torch.no_grad():
                self._scheduler_loop()
        except BaseException as exc:  # resolve every open future, then raise again on this thread
            self._crashed = exc
            leftovers: List[StreamHandle] = list(self._live_handles)
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    leftovers.append(item[0])
            for h in leftovers:
                h._fail(exc)
            raise

    def _drain_inbox(self, pending: deque, block: bool) -> None:
        try:
            item = self._inbox.get(timeout=self._idle_poll) if block else self._inbox.get_nowait()
        except queue.Empty:
            return
        while True:
            if item is not None:
                pending.append(item)
                self._live_handles.append(item[0])
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                return

    def _end(self, h: StreamHandle) -> None:
        if h in self._live_handles:
            self._live_handles.remove(h)
        h._finish()

    def _admit(self, pending: deque, slot_req: list) -> Optional[tuple]:
        """Drop cancelled requests at the head of the queue, then admit the next wave into the free slots in
        one prefill: (handles, slots, first tokens on the device), or None."""
        while pending and pending[0][0]._cancelled.is_set():
            self._end(pending.popleft()[0])
        free = [s for s, h in enumerate(slot_req) if h is None]
        m = self.engine._wave(len(free), len(pending))
        if m == 0:
            return None
        batch, slots = [pending.popleft() for _ in range(m)], free[:m]
        first = self.engine._admit_rows(np.stack([b[1] for b in batch]), np.stack([b[2] for b in batch]),
                                        np.asarray(slots), [h.req_index for h, _, _ in batch])
        return batch, slots, first

    def _bank(self, slot_req: list, slot: int, toks) -> bool:
        """Stream a slot's new tokens to its request, up to EOS (excluded) or its budget; True if it ended."""
        h = slot_req[slot]
        for t in toks:
            t = int(t)
            if self.engine.eos is not None and t == self.engine.eos:
                return True
            h._emit(t)
            if len(h._tokens) >= h.budget:
                return True
        return False

    def _stop_now(self, pending: deque) -> bool:
        """On ``stop(drain=False)``: end every pending request; True when running ones must stop too."""
        if not (self._stop.is_set() and not self._drain):
            return False
        for item in pending:
            self._end(item[0])
        pending.clear()
        return True

    def _scheduler_loop(self) -> None:
        if self.engine.spec_gamma:
            return self._speculative_scheduler_loop()
        eng = self.engine
        B = eng.num_slots
        pending: deque = deque()  # (handle, ids, mask)
        slot_req = self._slot_req

        def finish(slot: int) -> None:
            h, slot_req[slot] = slot_req[slot], None
            self._end(h)

        def settle(admission) -> None:
            if admission is None:
                return
            batch, slots, first = admission
            first = first.cpu().numpy()  # a decode chunk is already queued behind it
            for j, slot in enumerate(slots):
                if slot_req[slot]._cancelled.is_set() or self._bank(slot_req, slot, first[j:j + 1]):
                    finish(slot)

        def harvest(flight) -> None:
            if flight is None:
                return
            chunk, snapshot = flight
            chunk = chunk.cpu().numpy()  # the per-chunk host sync
            for slot in range(B):
                h = snapshot[slot]
                if h is None or h.done or slot_req[slot] is not h:
                    continue  # ended, or the slot was given to another request since the launch
                if h._cancelled.is_set() or self._bank(slot_req, slot, chunk[slot]):
                    finish(slot)

        # The rounds of DecodeEngine.generate: the next decode chunk is launched before the previous one is
        # read back; a slot freed in round r idles through round r + 1, already launched, and refills at r + 2.
        in_flight = None  # (chunk, slot -> handle snapshot at launch)
        unsettled = None  # an admission whose first tokens are not read yet
        while True:
            busy = any(s is not None for s in slot_req) or in_flight or unsettled or pending
            if not busy:
                if self._stop.is_set():
                    break
                self._drain_inbox(pending, block=True)
                if not pending:
                    continue
            else:
                self._drain_inbox(pending, block=False)
            if self._stop_now(pending):
                for h in slot_req:  # running requests stop at the next harvest
                    if h is not None:
                        h._cancelled.set()
            if any(s is not None for s in slot_req):
                snapshot = list(slot_req)
                active = np.array([h is not None for h in snapshot])
                req_arr = np.array([h.req_index if h is not None else 0 for h in snapshot], np.int64)
                next_flight = (eng._decode_chunk(active, req_arr), snapshot)
            else:
                next_flight = None
            settle(unsettled)
            harvest(in_flight)
            unsettled = self._admit(pending, slot_req)
            if unsettled is not None:
                for (h, _, _), slot in zip(unsettled[0], unsettled[1]):
                    slot_req[slot] = h
            in_flight = next_flight

    def _speculative_scheduler_loop(self) -> None:
        """Synchronous verify rounds (``DecodeEngine._generate_speculative``) with streaming emits and
        mid-flight admission: every request's tokens are the engine's."""
        eng = self.engine
        B, G = eng.num_slots, eng.spec_gamma
        pending: deque = deque()
        slot_req = self._slot_req
        slot_prompt: List[Optional[np.ndarray]] = [None] * B  # the unpadded prompt

        def finish(slot: int) -> None:
            h, slot_req[slot], slot_prompt[slot] = slot_req[slot], None, None
            self._end(h)

        while True:
            busy = any(s is not None for s in slot_req) or pending
            if not busy:
                if self._stop.is_set():
                    break
                self._drain_inbox(pending, block=True)
                if not pending:
                    continue
            else:
                self._drain_inbox(pending, block=False)
            if self._stop_now(pending):
                for slot in range(B):
                    if slot_req[slot] is not None:
                        finish(slot)
                continue
            admission = self._admit(pending, slot_req)
            if admission is not None:  # the first tokens are read now: the next drafts need them
                batch, slots, first = admission
                first = first.cpu().numpy()
                for j, ((h, ids, mask), slot) in enumerate(zip(batch, slots)):
                    slot_req[slot], slot_prompt[slot] = h, ids[mask > 0]
                    if h._cancelled.is_set() or self._bank(slot_req, slot, first[j:j + 1]):
                        finish(slot)
            active = np.array([h is not None for h in slot_req])
            if not active.any():
                continue
            drafts = np.zeros((B, G), np.int64)
            rem, req_arr, g0 = (np.zeros(B, np.int64) for _ in range(3))
            for slot in np.flatnonzero(active):
                h = slot_req[slot]
                drafts[slot] = eng.host_draft(np.concatenate([slot_prompt[slot], np.asarray(h._tokens, np.int64)]))
                rem[slot] = h.budget - len(h._tokens)
                req_arr[slot] = h.req_index
                g0[slot] = len(h._tokens)
            emit, m = eng._verify(active, drafts, rem, req_arr, g0)
            emit, m = emit.cpu().numpy(), m.cpu().numpy()
            for slot in np.flatnonzero(active):
                slot_req[slot].spec_rounds += 1
                if slot_req[slot]._cancelled.is_set() or self._bank(slot_req, slot, emit[slot, :m[slot]]):
                    finish(slot)
