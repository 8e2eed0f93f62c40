"""Executors and scheduler queues (paper §4.1.1).

Each graph has at least one scheduler queue; each scheduler queue has
exactly one executor; nodes are statically assigned to a queue.  The default
executor is a thread pool sized from the config.  The scheduler queue is a
priority queue — priorities come from the topological sort (nodes closer to
the graph output run first; sources last).
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, List, Optional, Tuple


class Executor:
    """A scheduler queue + its thread pool.

    ``on_error`` receives exceptions that escape ``run_task`` itself
    (scheduler/policy bugs, not calculator code — calculators' errors are
    caught inside the graph's task runner).  The graph wires this to its
    error path so a failed task terminates the run visibly instead of
    silently killing the worker loop's iteration and hanging
    ``wait_until_done``."""

    def __init__(self, name: str, num_threads: int,
                 run_task: Callable[[object], None],
                 on_error: Optional[Callable[[BaseException], None]] = None):
        self.name = name
        self.num_threads = max(1, num_threads)
        self._run_task = run_task
        self._on_error = on_error
        self._heap: List[Tuple[int, int, object]] = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._stopping = False
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        for i in range(self.num_threads):
            t = threading.Thread(target=self._worker,
                                 name=f"executor-{self.name}-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def submit(self, priority: int, task: object) -> None:
        with self._cv:
            # heapq pops the smallest tuple; higher priority must pop first.
            heapq.heappush(self._heap, (-priority, next(self._seq), task))
            self._cv.notify()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._stopping:
                    self._cv.wait()
                if self._stopping and not self._heap:
                    return
                _, _, task = heapq.heappop(self._heap)
            try:
                self._run_task(task)
            except BaseException as e:  # noqa: BLE001 - surface, don't die
                if self._on_error is not None:
                    try:
                        self._on_error(e)
                    except Exception:  # pragma: no cover - last resort
                        import traceback
                        traceback.print_exc()
                else:  # pragma: no cover - graphs always pass on_error
                    import traceback
                    traceback.print_exc()

    def stop(self, join: bool = True) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if join:
            for t in self._threads:
                t.join(timeout=5.0)
        self._threads.clear()

    def queued(self) -> int:
        with self._cv:
            return len(self._heap)
