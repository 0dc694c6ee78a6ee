"""Worker pools for host chores that must stay off the paced tick loop
(port of ``reset_thread_priority`` and ``normal_priority_pool`` from
``mediastreamer2_tpu/core/worker.py``; the rest of that module is not on
the port's path yet)."""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor


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
