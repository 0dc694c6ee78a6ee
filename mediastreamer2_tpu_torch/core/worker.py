"""WorkerThread / Task — generic background task execution (port of
``mediastreamer2_tpu/core/worker.py``: plain Python).

Reference: MSWorkerThread (src/base/msasync.c:23-110): a thread with a task
queue, cancellation, repeat-interval tasks and wait-for-completion — used
by TURN TCP, screen sharing, video toolbox backends.  Same surface here;
the framework uses it for host-side I/O chores that must stay off the tick
loop (the reference's latency-isolation role).

Also ms_discover_mtu parity (src/base/mtu.c): kernel path-MTU query, the
worker pools whose threads run at nice 0, and ``priority_pool``, whose
threads run at a fixed niceness (the mixed fleet's dispatch worker).

Also ``StreamRegulator``, the media player's timestamp pacing of video
frames.
"""
from __future__ import annotations

import heapq
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional


class Task:
    def __init__(self, fn: Callable[[], Any], repeat_interval_s: float = 0.0):
        self.fn = fn
        self.repeat_interval_s = repeat_interval_s
        self.done = threading.Event()
        self.cancelled = False
        self.result: Any = None
        self.error: Optional[BaseException] = None

    def cancel(self):
        """cf. ms_task_cancel — skips (future) executions."""
        self.cancelled = True
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """cf. ms_task_wait_completion."""
        return self.done.wait(timeout)


class WorkerThread:
    """cf. ms_worker_thread_new / add_task / add_repeated_task."""

    def __init__(self, name: str = "ms2-worker"):
        self._heap = []                      # (due_time, seq, Task)
        self._seq = 0
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def add_task(self, fn: Callable[[], Any]) -> Task:
        return self._schedule(Task(fn), delay_s=0.0)

    def add_repeated_task(self, fn: Callable[[], Any],
                          interval_s: float) -> Task:
        return self._schedule(Task(fn, repeat_interval_s=interval_s),
                              delay_s=interval_s)

    def _schedule(self, task: Task, delay_s: float) -> Task:
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, (time.monotonic() + delay_s,
                                        self._seq, task))
            self._cv.notify()
        return task

    def _run(self):
        while True:
            with self._cv:
                while not self._stop and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    timeout = (self._heap[0][0] - time.monotonic()
                               if self._heap else None)
                    self._cv.wait(timeout=timeout)
                if self._stop:
                    return
                _, _, task = heapq.heappop(self._heap)
            if task.cancelled:
                continue
            try:
                task.result = task.fn()
            except BaseException as e:        # surfaced via task.error
                task.error = e
            if task.repeat_interval_s > 0 and not task.cancelled:
                self._schedule(task, task.repeat_interval_s)
            else:
                task.done.set()

    def destroy(self):
        """cf. ms_worker_thread_destroy."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=2.0)


def discover_mtu(host: str, port: int = 5060) -> int:
    """Path-MTU discovery (cf. ms_discover_mtu, src/base/mtu.c): connect a
    UDP socket and read the kernel's cached path MTU. Returns -1 where the
    kernel refuses the path-MTU socket options (gVisor answers
    IP_MTU_DISCOVER with EOPNOTSUPP), as the reference reports a failed
    socket call; the JAX package raises there."""
    IP_MTU = 14
    IP_MTU_DISCOVER = 10
    IP_PMTUDISC_DO = 2
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        try:
            s.setsockopt(socket.IPPROTO_IP, IP_MTU_DISCOVER, IP_PMTUDISC_DO)
        except OSError:
            return -1
        s.connect((host, port))
        try:
            s.send(b"\x00" * 16)
        except OSError:
            pass
        try:
            return s.getsockopt(socket.IPPROTO_IP, IP_MTU)
        except OSError:
            return -1
    finally:
        s.close()


class StreamRegulator:
    """Timestamp-paced frame release (reference: utils/stream_regulator.c --
    buffers frames and releases each when the stream clock reaches its
    timestamp; the player's A/V pacing helper)."""

    def __init__(self, clock_rate: int = 90000):
        self.clock_rate = clock_rate
        self._queue: list = []            # [(ts, frame)]
        self._origin_ts = None
        self._origin_time = None

    def push(self, ts: int, frame):
        self._queue.append((ts, frame))

    def pop_due(self, now_s: float) -> list:
        """Frames whose timestamp has been reached on the stream clock."""
        if not self._queue:
            return []
        if self._origin_ts is None:
            self._origin_ts = self._queue[0][0]
            self._origin_time = now_s
        elapsed_units = (now_s - self._origin_time) * self.clock_rate
        due, rest = [], []
        for ts, frame in self._queue:
            if ts - self._origin_ts <= elapsed_units:
                due.append(frame)
            else:
                rest.append((ts, frame))
        self._queue = rest
        return due

    def reset(self):
        self._queue.clear()
        self._origin_ts = None


def reset_thread_priority() -> None:
    """Reset the calling thread's niceness to 0 (best-effort).

    Linux threads inherit the creator's nice value, so worker pools created
    from an elevated (nice -10) paced thread would run elevated too,
    defeating the differential that lets the paced loop win the wakeup race
    over its workers. Use as a ThreadPoolExecutor initializer."""
    try:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 0)
    except OSError:
        pass


def normal_priority_pool(max_workers: int = 1, name: str = "ms2tpu-worker"):
    """ThreadPoolExecutor whose workers always run at nice 0, regardless of
    the creating thread's elevation (see reset_thread_priority)."""
    return ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix=name,
                              initializer=reset_thread_priority)


def priority_pool(max_workers: int = 1, name: str = "ms2tpu-worker", nice: int = 0):
    """ThreadPoolExecutor whose workers run at a fixed niceness.

    The mixed fleet's shared dispatch worker runs every member's paced
    deadline work (do_ticks, tick uploads) while publish and codec pools
    do latency-tolerant work behind a pipeline, so it runs between the
    paced loop (-10) and those pools (0). A nice level the process may not
    take (a negative one needs CAP_SYS_NICE) leaves the worker at its
    inherited niceness, without a word, as in the JAX package."""
    def _init():
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), nice)
        except (AttributeError, OSError):
            pass

    return ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix=name,
                              initializer=_init)
