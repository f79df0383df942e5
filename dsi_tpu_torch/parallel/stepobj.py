"""Resumable step objects: the streaming engine as an explicit state
machine.

Copy of ``dsi_tpu/parallel/stepobj.py`` (``EngineStep`` and
``HostPathStep``), with the rung-restart hook the TF-IDF wave walk
uses.  The lifecycle:

* ``advance()`` — one turn of the crank: dispatch the next item, retiring
  the oldest in-flight record when the window is full.  False when the
  engine is finished (input exhausted, window drained, result built) or
  routed to the host path.
* ``confirm()`` — retire every in-flight record, leaving the engine at a
  confirmed boundary; returns the confirmed-step count.
* ``abort()``   — tear down without driving the remaining input.
* ``checkpoint()`` — ``confirm()``, then one durable snapshot through the
  engine's own save path, drained so the manifest is on disk; False
  when the engine was built without a checkpoint dir.
* ``restore()`` — what the constructor-time restore did (``resume=True``
  restores before the first dispatch).
* ``suspend()`` — ``checkpoint()`` then release: a fresh ``resume=True``
  construction continues bit-identically.
* ``close()``   — finish the run, release every resource and return the
  result (None on the host path).

Subclass contract (attributes set by ``__init__``): ``_pipe`` (a begun
:class:`~dsi_tpu_torch.parallel.pipeline.StepPipeline`), ``_host_excs``
(exception types meaning "this input needs the host path"),
``_rung_excs`` (exception types that :meth:`EngineStep._next_rung`
consumes: tear the rung down and begin the next one), ``_on_complete``
(run once after the window drains at end of input), ``_release``
(idempotent teardown), ``_save`` (commits one snapshot at the current
confirmed boundary; None = checkpointing off), ``_writer`` (the engine's
``CheckpointWriter``, so ``checkpoint()`` can drain it) and
``_cursor_ref`` (the live confirmed-cursor dict of an engine with a byte
cursor).
"""

from __future__ import annotations


class EngineStep:
    """Base step object.  Phases: ``running`` → ``done`` | ``hostpath`` |
    ``failed`` | ``cancelled`` | ``suspended``; ``close()`` maps each to
    a result (or None)."""

    #: Exception types that route the stream to the host path.
    _host_excs: tuple = ()
    #: Exception types consumed by :meth:`_next_rung`.
    _rung_excs: tuple = ()

    def __init__(self) -> None:
        self.result = None
        self._phase = "running"
        self._pipe = None
        self._on_complete = lambda: None
        self._release = lambda: None
        self._save = None
        self._writer = None
        self._restore_info: dict = {}
        self._cursor_ref = None

    def _next_rung(self) -> bool:
        """Consume a rung-restart exception: tear the old rung down and
        begin the next one.  True when a fresh rung is armed; False when
        the walk is over (the phase already moved).  The base class has
        no rungs."""
        return False

    @property
    def phase(self) -> str:
        return self._phase

    @property
    def confirmed(self) -> int:
        """Steps retired through their deferred checks so far."""
        return self._pipe.finished if self._pipe is not None else 0

    @property
    def cursor(self) -> int:
        """The confirmed input-byte cursor: the offset just past the last
        confirmed step's batch (0 for engines without a byte cursor)."""
        ref = self._cursor_ref
        return int(ref.get("offset", 0)) if ref else 0

    def advance(self) -> bool:
        """One turn of the crank; False when there is nothing left to do
        (finished, host path, or already released)."""
        if self._phase != "running":
            return False
        try:
            if self._pipe.pump():
                return True
            # Input exhausted: drain the window (deferred checks of the
            # tail), tear the producer down, then the engine epilogue.
            self._pipe.drain()
            self._pipe.end()
            self._on_complete()
            self._phase = "done"
            return False
        except self._rung_excs:
            return self._next_rung()
        except self._host_excs:
            self._to_hostpath()
            return False
        except BaseException:
            self._fail()
            raise

    def advance_slice(self, k: int) -> int:
        """Up to ``k`` turns of the crank; returns the turns taken."""
        n = 0
        while n < k and self.advance():
            n += 1
        return n

    def abort(self) -> None:
        """Cancel a running engine without driving the remaining input;
        idempotent."""
        if self._phase != "running":
            return
        try:
            if self._pipe is not None:
                self._pipe.end()
        finally:
            self._release()
        self.result = None
        self._phase = "cancelled"

    def confirm(self) -> int:
        """Retire every in-flight record; returns the confirmed count."""
        if self._phase == "running":
            try:
                self._pipe.drain()
            except self._rung_excs:
                self._next_rung()
            except self._host_excs:
                self._to_hostpath()
            except BaseException:
                self._fail()
                raise
        return self.confirmed

    def checkpoint(self) -> bool:
        """Force one durable snapshot at a confirmed boundary.  False when
        checkpointing is off or the engine left the running phase."""
        self.confirm()
        if self._phase != "running" or self._save is None:
            return False
        self._save()
        if self._writer is not None:
            self._writer.drain()
        return True

    def restore(self) -> dict:
        """What the constructor-time restore did (``resume_cursor``,
        ``resume_gap_s``); empty when the engine started fresh."""
        return dict(self._restore_info)

    def suspend(self) -> bool:
        """Checkpoint (when enabled) and release everything; returns
        whether a snapshot was committed."""
        if self._phase != "running":
            return False
        saved = self.checkpoint()
        if self._phase == "running":
            self._pipe.end()
            self._release()
            self._phase = "suspended"
        return saved

    def close(self):
        """Finish the run (driving any remaining input) and return the
        result — None on the host path.  Always releases resources; safe
        to call more than once."""
        while self.advance():
            pass
        self._release()
        return self.result

    def _to_hostpath(self) -> None:
        if self._pipe is not None:
            self._pipe.end()
        self.result = None
        self._phase = "hostpath"

    def _fail(self) -> None:
        self._phase = "failed"
        try:
            if self._pipe is not None:
                self._pipe.end()
        finally:
            self._release()


class HostPathStep(EngineStep):
    """A step object routed to the host path at construction: already
    terminal, result None."""

    def __init__(self) -> None:
        super().__init__()
        self._phase = "hostpath"
