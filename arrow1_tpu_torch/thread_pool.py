"""Threading runtime: ThreadPool / Future / TaskGroup (counterpart of
arrow1_tpu/thread_pool.py).

Reference: cpp/src/arrow/util/thread_pool.h:249 (ThreadPool with dynamic
SetCapacity + global CPU pool), util/future.h (Future with callbacks),
util/task_group.h:42 (serial + threaded TaskGroup: Append/Finish,
first-error propagation, ok() early-stop).

Own worker/queue machinery (threading primitives only — this is the
component, not a wrapper over concurrent.futures). The *device*
parallelism belongs to CUDA; this pool runs the host plane: file IO,
decode, IPC assembly, where the reference spends its CPU threads. Capacity semantics follow the reference: capacity
can be raised (spawns workers on demand) or lowered (idle workers retire;
busy ones finish their task first); tasks submitted to a shut-down pool
raise Invalid.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Callable, List, Optional

from .errors import Invalid

__all__ = ["Future", "ThreadPool", "TaskGroup", "cpu_thread_pool",
           "cpu_count", "set_cpu_thread_pool_capacity", "parallel_map"]

_UNSET = object()


class Future:
    """util/future.h analogue: a one-shot value/error slot with
    completion callbacks that run exactly once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._value = _UNSET
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable] = []

    # -- producer side --
    def mark_finished(self, value=None) -> None:
        with self._lock:
            if self._done.is_set():
                raise Invalid("Future already finished")
            self._value = value
            cbs, self._callbacks = self._callbacks, []
            self._done.set()
        for cb in cbs:
            cb(self)

    def mark_error(self, exc: BaseException) -> None:
        with self._lock:
            if self._done.is_set():
                raise Invalid("Future already finished")
            self._error = exc
            cbs, self._callbacks = self._callbacks, []
            self._done.set()
        for cb in cbs:
            cb(self)

    # -- consumer side --
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("Future.result timed out")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("Future.exception timed out")
        return self._error

    def add_callback(self, cb: Callable[["Future"], None]) -> None:
        """Run cb(self) on completion — immediately if already done
        (future.h AddCallback semantics)."""
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def then(self, on_value: Callable, on_error: Callable = None
             ) -> "Future":
        """Chain: returns a Future of on_value(result) (future.h Then)."""
        out = Future()

        def fire(f: "Future"):
            try:
                if f._error is not None:
                    if on_error is not None:
                        out.mark_finished(on_error(f._error))
                    else:
                        out.mark_error(f._error)
                else:
                    out.mark_finished(on_value(f._value))
            except BaseException as e:
                out.mark_error(e)

        self.add_callback(fire)
        return out


def cpu_count() -> int:
    env = os.environ.get("A1T_NUM_THREADS") or os.environ.get(
        "OMP_NUM_THREADS")
    if env:
        try:
            return max(1, int(env.split(",")[0]))
        except ValueError:
            pass
    return os.cpu_count() or 1


class ThreadPool:
    """thread_pool.h:249 analogue. FIFO task queue, lazily spawned
    workers up to `capacity`, dynamic resize, clean shutdown."""

    def __init__(self, capacity: Optional[int] = None):
        self._capacity = capacity if capacity else cpu_count()
        if self._capacity <= 0:
            raise Invalid(f"ThreadPool capacity must be > 0, got "
                          f"{self._capacity}")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._workers: List[threading.Thread] = []
        self._idle = 0
        self._desired = self._capacity
        self._shutdown = False

    # -- introspection (GetCapacity / GetNumTasks) --
    @property
    def capacity(self) -> int:
        return self._desired

    def num_tasks(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- capacity management (SetCapacity semantics) --
    def set_capacity(self, n: int) -> None:
        if n <= 0:
            raise Invalid(f"capacity must be > 0, got {n}")
        with self._cv:
            self._desired = n
            # wake idle workers so excess ones retire
            self._cv.notify_all()
            self._maybe_spawn_locked()

    def _maybe_spawn_locked(self) -> None:
        # spawn only when there is queued work no idle worker will take
        while (len(self._workers) < self._desired and
               len(self._queue) > self._idle):
            t = threading.Thread(target=self._worker, daemon=True)
            self._workers.append(t)
            t.start()

    def _worker(self) -> None:
        me = threading.current_thread()
        while True:
            with self._cv:
                self._idle += 1
                while (not self._queue and not self._shutdown and
                       len(self._workers) <= self._desired):
                    self._cv.wait()
                self._idle -= 1
                if self._queue:
                    fn, args, fut = self._queue.popleft()
                elif self._shutdown or len(self._workers) > self._desired:
                    self._workers.remove(me)
                    self._cv.notify_all()
                    return
                else:
                    continue
            try:
                fut.mark_finished(fn(*args))
            except BaseException as e:
                try:
                    fut.mark_error(e)
                except Invalid:
                    pass
            # an idle worker keeps no reference to the task it ran (its
            # arguments may be batches on the card)
            fn = args = fut = None

    def submit(self, fn: Callable, *args) -> Future:
        fut = Future()
        with self._cv:
            if self._shutdown:
                raise Invalid("ThreadPool is shut down")
            self._queue.append((fn, args, fut))
            self._maybe_spawn_locked()
            self._cv.notify()
        return fut

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            if not wait:
                self._queue.clear()
            self._cv.notify_all()
            if wait:
                while self._workers and (self._queue or
                                         self._idle < len(self._workers)):
                    self._cv.wait(0.05)
        if wait:
            # all queued work drained; workers retire on next wake
            for t in list(self._workers):
                t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


_cpu_pool: Optional[ThreadPool] = None
_cpu_pool_lock = threading.Lock()


def cpu_thread_pool() -> ThreadPool:
    """Global CPU pool (GetCpuThreadPool, thread_pool.h:321)."""
    global _cpu_pool
    with _cpu_pool_lock:
        if _cpu_pool is None:
            _cpu_pool = ThreadPool(cpu_count())
        return _cpu_pool


def set_cpu_thread_pool_capacity(n: int) -> None:
    cpu_thread_pool().set_capacity(n)


class TaskGroup:
    """task_group.h:42 analogue.

    threaded=True -> tasks run on the pool; False -> serial TaskGroup
    (tasks run inline at append, short-circuiting after the first error —
    the reference's SerialTaskGroup behavior).
    """

    def __init__(self, threaded: bool = True,
                 pool: Optional[ThreadPool] = None):
        self._threaded = threaded
        self._pool = pool or (cpu_thread_pool() if threaded else None)
        self._lock = threading.Lock()
        self._pending = 0
        self._error: Optional[BaseException] = None
        self._done_cv = threading.Condition(self._lock)
        self._finished = False

    def ok(self) -> bool:
        """current_status().ok() — non-blocking early-stop check."""
        with self._lock:
            return self._error is None

    def append(self, fn: Callable, *args) -> None:
        with self._lock:
            if self._finished:
                raise Invalid("TaskGroup already finished")
            if self._error is not None:
                return  # stop scheduling after first error
            self._pending += 1
        if not self._threaded:
            try:
                fn(*args)
            except BaseException as e:
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._done_cv:
                    self._pending -= 1
                    self._done_cv.notify_all()
            return

        def run():
            try:
                fn(*args)
            except BaseException as e:
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._done_cv:
                    self._pending -= 1
                    self._done_cv.notify_all()

        self._pool.submit(run)

    def finish(self) -> None:
        """Wait for all appended tasks; raise the first error."""
        with self._done_cv:
            while self._pending:
                self._done_cv.wait()
            self._finished = True
            if self._error is not None:
                raise self._error

    def finish_async(self) -> Future:
        """FinishAsync: a Future completing when all tasks are done."""
        out = Future()

        def waiter():
            try:
                self.finish()
                out.mark_finished(None)
            except BaseException as e:
                out.mark_error(e)

        threading.Thread(target=waiter, daemon=True).start()
        return out

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.finish()


def parallel_map(fn: Callable, items, pool: Optional[ThreadPool] = None
                 ) -> list:
    """Ordered parallel map over the CPU pool (the reference's
    ParallelFor, thread_pool.h:66 OptionalParallelFor shape)."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    pool = pool or cpu_thread_pool()
    futs = [pool.submit(fn, x) for x in items]
    return [f.result() for f in futs]
