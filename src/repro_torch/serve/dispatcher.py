"""Async dispatcher: a background thread that runs the service's tick loop
(a copy of ``repro/serve/dispatcher.py``).

The synchronous shape (``submit`` … ``tick`` … read responses) is what the
tests drive; a deployment wants submits from tenant threads answered
without anyone calling ``tick``. :class:`Dispatcher` provides exactly that
hand-off:

* tenant threads call :meth:`submit` (same signature as
  ``SolveService.submit``) and block on ``SolveRequest.result()`` — the
  tick loop fires each request's ``done`` event via ``req.finish``;
* the dispatcher thread waits on a condition variable with a short timeout
  (so deadlines expire even with no new traffic), ticks while there is
  queued work, and parks when idle;
* :meth:`stop` is a clean shutdown: wake the thread, let it finish the
  in-flight tick, join. Requests still queued at stop time are drained by
  one final tick so nobody blocks forever.

The dispatcher deliberately owns **no** solver state — it is a thread and
a condition variable around ``service.tick()``; all batching, degradation,
and bit-compat behaviour stays in :class:`~repro_torch.serve.service.SolveService`
(``tick`` is serialized by the service's own tick lock, so a stray manual
``tick()`` during dispatcher operation is safe, just pointless).
"""
from __future__ import annotations

import threading
from typing import Optional


class Dispatcher:
    """Background tick loop for a :class:`~repro_torch.serve.service.SolveService`.

    Usage::

        with Dispatcher(svc) as d:
            req = d.submit("tenant", "m0", b)
            resp = req.result(timeout=30)
    """

    def __init__(self, service, idle_wait: float = 0.05):
        self.service = service
        self.idle_wait = float(idle_wait)
        self._cv = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.ticks_run = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Dispatcher":
        if self._thread is not None:
            raise RuntimeError("dispatcher already started")
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="serve-dispatcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Clean shutdown: wake the loop, finish in-flight work, join."""
        t = self._thread
        if t is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t.join(timeout)
        self._thread = None
        # anything still queued (raced the shutdown) gets one final tick so
        # no submitter blocks forever on result()
        if len(self.service.queue):
            self.service.run_until_idle()

    def __enter__(self) -> "Dispatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- tenant surface ----------------------------------------------------
    def submit(self, *args, **kw):
        """``SolveService.submit`` plus a wake-up: returns the pending
        request (block on ``.result()``) or the immediate failure response."""
        res = self.service.submit(*args, **kw)
        with self._cv:
            self._cv.notify_all()
        return res

    def notify(self) -> None:
        """Wake the loop early (e.g. after submitting via the service)."""
        with self._cv:
            self._cv.notify_all()

    # -- the loop ----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                if not len(self.service.queue):
                    # bounded wait: deadlines must expire and stop() must
                    # land even if no submit ever notifies again
                    self._cv.wait(self.idle_wait)
                    if self._stop:
                        return
            if len(self.service.queue):
                try:
                    self.service.tick()
                except Exception:  # noqa: BLE001 — the loop must survive; the
                    # batch-level handlers already turned what they could
                    # into structured responses
                    pass
                self.ticks_run += 1
