"""The async agents' decisions across processes: one rank decides, the
others replay.

In ``loose`` and ``free`` the mapper thread and the tracking thread run at
once, and the JAX package's ``_run_async`` leaves four things to thread
timing:

  - which agent's unit of device work runs next (its ``dispatch_lock``): a
    map job or the tracking of a frame;
  - whether a finished map job publishes a snapshot or skips
    (``publish_skip`` reads whether the tracker took the last one);
  - which published snapshot a tracked frame reads;
  - whether the last frame needs the stale fix-up publish.

In one process that is harmless. On a shared dp group every rank runs both
agents and every unit issues collectives, so every rank must decide alike:
the lead takes each decision as the JAX package does and appends it to a log
in a key-value store, and every other rank (a follower) reads the log in
order and runs what it says, evaluating no gate of its own
(``UnitSchedule``). Under ``parallel.split`` the track lead decides for the
track ranks, and the agents' messages travel through the same store
(``Channel``; ``slam/system.py:_run_split``).

The log never blocks the lead: a record is one ``set``. A follower waits for
the next record for up to ``GROUP_TIMEOUT_S``. A rank that fails writes its
error into the store (``Peers.failure``), and every other rank raises it from
its next wait, or from the collective its peer's exit broke.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch.distributed as dist

from attentive_dfprior_tpu_torch.parallel.sharding import GROUP_TIMEOUT_S

PEER_POLL_S = 0.5  # how often a waiting rank looks for another rank's error in the store


class PeerFailure(RuntimeError):
    """Another rank of the run failed; the message is its error."""


def open_store() -> Any:
    """A key-value store every rank of the process group reaches: a
    ``TCPStore`` hosted by rank 0 on a free port of the launcher's address
    (``MASTER_ADDR``, else ``DFPRIOR_COORD``'s host), the port broadcast
    over the world. Collective: every rank calls it, from the main thread.
    Rank 0's process must outlive the others' reads (``finish``)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    host = os.environ.get("MASTER_ADDR") or os.environ.get("DFPRIOR_COORD", "127.0.0.1:0").rsplit(":", 1)[0]
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore(host, 0, world, True, timeout=timeout, wait_for_workers=False) if rank == 0 else None
    port = [store.port if store is not None else 0]
    dist.broadcast_object_list(port, src=0)
    return store if store is not None else dist.TCPStore(host, port[0], world, False, timeout=timeout)


def wait_key(store, key: str, check: Callable[[], None], timeout_s: float = GROUP_TIMEOUT_S) -> bytes:
    """``store``'s value at ``key`` once it is set, calling ``check`` (which
    raises to give up) while it waits; raises ``TimeoutError`` after
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    pause = 1e-3
    while not store.check([key]):
        check()
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {key!r} in the schedule's store after {timeout_s:.0f} s")
        time.sleep(pause)
        pause = min(2 * pause, 0.02)
    return store.get(key)


class Peers:
    """The ranks of one run, as seen from ``rank``: a rank that fails writes
    its error under ``error/<rank>``, and the others raise it as a
    ``PeerFailure`` from their next ``check``."""

    def __init__(self, store, rank: int, ranks: Sequence[int]):
        self.store, self.rank, self.ranks = store, rank, tuple(ranks)
        self.local: Optional[BaseException] = None  # this rank's first error, from any thread
        self._next_poll = 0.0

    def peer_error(self) -> Optional[str]:
        for r in self.ranks:
            if r != self.rank and self.store.check([f"error/{r}"]):
                return f"rank {r} failed: {self.store.get(f'error/{r}').decode()}"
        return None

    def check(self) -> None:
        """Raise this rank's error (another thread's), or another rank's."""
        if self.local is not None:
            raise self.local
        now = time.monotonic()
        if now >= self._next_poll:
            self._next_poll = now + PEER_POLL_S
            err = self.peer_error()
            if err is not None:
                raise PeerFailure(err)

    def failure(self, exc: BaseException) -> BaseException:
        """What this rank raises for ``exc``: another rank's error when one
        was reported (``exc`` is then that failure's echo, a broken
        collective or a wait given up), else ``exc``, which is reported for
        the others."""
        if self.local is None:
            self.local = exc
        if isinstance(exc, PeerFailure):
            return exc
        err = self.peer_error()
        if err is not None:
            return PeerFailure(err)
        try:
            if not self.store.check([f"error/{self.rank}"]):
                self.store.set(f"error/{self.rank}", f"{type(exc).__name__}: {exc}")
        except Exception:  # noqa: BLE001 (the store's host is gone: nothing to tell)
            pass
        return exc

    def finish(self) -> None:
        """Mark this rank done; rank 0, which hosts the store, returns only
        when every other rank is done reading it."""
        self.store.set(f"fin/{self.rank}", "1")
        if self.rank == 0:
            for r in self.ranks:
                if r != 0:
                    wait_key(self.store, f"fin/{r}", self.check)


class Channel:
    """An append-only sequence of JSON records under ``name`` in a store:
    one rank appends, any rank reads record ``i``, waiting for it."""

    def __init__(self, store, name: str, check: Callable[[], None] = lambda: None):
        self.store, self.name, self.check = store, name, check
        self.n = 0  # records appended here

    def append(self, rec: Dict[str, Any]) -> None:
        self.store.set(f"{self.name}/{self.n}", json.dumps(rec))
        self.n += 1

    def read(self, i: int) -> Dict[str, Any]:
        return json.loads(wait_key(self.store, f"{self.name}/{i}", self.check))


class UnitSchedule:
    """The global dispatch lock of a shared dp group: units of device work
    run one at a time, in the lead's order, on every rank.

    ``unit(kind, idx, decide)`` is the grant of one unit: ``"map"`` (a map
    job, on the mapper thread), ``"track"`` or ``"final"`` (on the main
    thread). On the lead it takes a lock, evaluates ``decide()`` (the
    decisions the unit needs: publish or skip, the snapshot read, the stale
    fix-up) and appends them to the log with the unit; on a follower it
    waits until the log's next record is this unit, and yields the lead's
    decisions. Leaving a unit runs ``sync`` (the calling thread's stream)
    before the next unit may start. ``records`` holds the log as this rank
    appended or replayed it.
    """

    def __init__(self, store, peers: Peers, lead: bool, sync: Callable[[], None] = lambda: None):
        self.peers, self.lead, self.sync = peers, lead, sync
        self.log = Channel(store, "units", peers.check)
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()  # the lead's dispatch lock
        self._cursor = threading.Condition()  # a follower's place in the log
        self._at = 0
        self._next: Optional[Dict[str, Any]] = None

    @contextlib.contextmanager
    def unit(self, kind: str, idx: int, decide: Callable[[], Dict[str, Any]] = dict) -> Iterator[Dict[str, Any]]:
        if self.lead:
            while not self._lock.acquire(timeout=0.05):
                self.peers.check()
            try:
                rec = {"unit": kind, "idx": int(idx), **decide()}
                self.log.append(rec)
                self.records.append(rec)
                yield rec
                self.sync()
            finally:
                self._lock.release()
            return
        mine = "map" if kind == "map" else "main"
        with self._cursor:
            while True:
                if self._next is None:
                    self._next = self.log.read(self._at)
                rec = self._next
                if ("map" if rec["unit"] == "map" else "main") == mine:
                    if (rec["unit"], rec["idx"]) != (kind, int(idx)):
                        raise RuntimeError(f"the schedule's replay diverged: the lead ran {rec}, this rank "
                                           f"asks for {kind} {idx}")
                    break
                self._cursor.wait(0.05)
                self.peers.check()
        try:
            yield rec
            self.sync()
        finally:
            with self._cursor:
                self.records.append(rec)
                self._at += 1
                self._next = None
                self._cursor.notify_all()
