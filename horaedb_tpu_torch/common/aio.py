"""A copy of the JAX package's `common/aio.py`.

Asyncio compatibility shims.

`TaskGroup` is `asyncio.TaskGroup` on Python >= 3.11; on 3.10 images a
minimal structured-concurrency backport with the same contract the
engine relies on: children run concurrently, the first child failure
cancels the siblings, and exiting the block never leaks a running task
(including tasks a child spawned during the drain, and on parent
cancellation mid-drain).
Documented divergences from the real one (acceptable for the engine's
exit-block-immediately call sites; revisit before leaning on them):
- a lone child failure re-raises the exception itself rather than
  wrapping it in an ExceptionGroup (no caller uses `except*`);
- a child failure does NOT abort the body mid-flight — siblings are
  only cancelled at block exit, where the real TaskGroup cancels the
  moment the child fails;
- if the BODY raises, children are cancelled and reaped but their own
  exceptions are discarded rather than grouped with the body's.
"""

from __future__ import annotations

import asyncio

try:
    TaskGroup = asyncio.TaskGroup  # Python >= 3.11
except AttributeError:

    class TaskGroup:  # type: ignore[no-redef]
        def __init__(self) -> None:
            self._tasks: list[asyncio.Task] = []
            self._entered = False
            self._finished = False

        async def __aenter__(self) -> "TaskGroup":
            self._entered = True
            return self

        def create_task(self, coro, *, name=None) -> asyncio.Task:
            # like the real TaskGroup: spawning before entry or after
            # exit is a bug (nobody would supervise the task), and
            # calling from sync code must raise (get_running_loop), not
            # queue on a fresh never-run loop
            if not self._entered:
                coro.close()
                raise RuntimeError("TaskGroup has not been entered")
            if self._finished:
                coro.close()
                raise RuntimeError("TaskGroup is finished")
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                coro.close()  # refuse cleanly: no orphan coroutine warning
                raise
            t = loop.create_task(coro, name=name)
            self._tasks.append(t)
            return t

        async def _reap_all(self) -> None:
            """Cancel and await every outstanding child. Loops on a FRESH
            snapshot each round: a child's except/finally handler may
            spawn more tasks via create_task while we reap, and those
            must not outlive the block either. A SECOND parent
            cancellation delivered mid-reap must not abort the reap —
            finish reaping first, then re-raise it, or children outlive
            the block."""
            interrupted: BaseException | None = None
            while True:
                pending = [t for t in self._tasks if not t.done()]
                if not pending:
                    break
                for t in pending:
                    t.cancel()
                try:
                    await asyncio.gather(*pending, return_exceptions=True)
                except BaseException as e:  # re-delivered parent cancel
                    interrupted = e
            if interrupted is not None:
                raise interrupted

        async def __aexit__(self, exc_type, exc, tb) -> bool:
            try:
                if exc is not None:
                    # body raised (incl. CancelledError): abort children
                    await self._reap_all()
                    return False
                first: BaseException | None = None
                try:
                    while True:
                        # re-snapshot each round: a child may have
                        # spawned siblings during the drain — the real
                        # TaskGroup joins those too
                        pending = {t for t in self._tasks if not t.done()}
                        if not pending:
                            break
                        if first is not None:
                            await self._reap_all()
                            continue
                        done, _ = await asyncio.wait(
                            pending, return_when=asyncio.FIRST_EXCEPTION
                        )
                        for t in done:
                            if t.cancelled():
                                continue
                            e = t.exception()
                            if e is not None and first is None:
                                first = e
                except BaseException:
                    # the PARENT was cancelled (or the wait machinery
                    # failed) mid-drain: children must not outlive the
                    # block — reap before propagating, or shutdown-time
                    # cancels leave writers running against a closing
                    # store
                    await self._reap_all()
                    raise
                if first is not None:
                    raise first
                return False
            finally:
                self._finished = True
