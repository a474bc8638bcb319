"""Cross-process access: one writer process, many reader processes. The
port of ``tpuvec/store/follower.py``.

* the WRITER process owns the device state and publishes committed rows
  through the atomic autosave snapshot (``VecTable(...,
  autosave_path=...)``, store/table.py): tmp + rename, so readers never
  observe a torn file;
* READER processes hold a :class:`SnapshotFollower` on the snapshot
  path: ``refresh()`` reloads the table iff the writer published a new
  generation (mtime / size change), on the reader's own device;
* :func:`writer_lock` makes a second writer fail fast (``InvalidState``)
  instead of silently diverging.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from tpuvec_torch.types import InvalidState

__all__ = ["SnapshotFollower", "writer_lock"]


@contextmanager
def writer_lock(path: str):
    """Exclusive writer lock for a snapshot path (``path + ".lock"``).

    Holds an OS-level ``flock`` for the duration of the context; a second
    process (or a second open in the same process) entering the context
    raises InvalidState immediately.
    """
    import fcntl

    lock_path = path + ".lock"
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise InvalidState(f"another writer holds {lock_path}") from None
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)
        except OSError:
            pass


class SnapshotFollower:
    """Read-only follower of a writer's autosave snapshot.

    ``refresh()`` polls the file generation and reloads on change;
    ``table`` is the most recently loaded :class:`VecTable`, on
    ``device`` (default ``"cuda"``).
    """

    def __init__(self, path: str, *, mesh=None, device: str | torch.device = "cuda"):
        self.path = path
        self.mesh = mesh
        self.device = device
        self._stamp: tuple | None = None
        self._table = None
        self.refresh()

    @property
    def table(self):
        if self._table is None:
            raise InvalidState(f"no snapshot at {self.path} yet")
        return self._table

    def generation(self) -> tuple | None:
        """(mtime_ns, size) of the current snapshot file, None if absent."""
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def refresh(self) -> bool:
        """Reload if the writer published a new generation. Returns True
        when the table was reloaded."""
        stamp = self.generation()
        if stamp is None or stamp == self._stamp:
            return False
        from tpuvec_torch.store import snapshot

        self._table = snapshot.load(self.path, mesh=self.mesh, device=self.device)
        self._stamp = stamp
        return True

    # convenience passthroughs (readers are query-only)
    def knn(self, *a, **kw):
        return self.table.knn(*a, **kw)

    def row(self, rowid: int):
        return self.table.row(rowid)

    def __len__(self) -> int:
        return len(self.table)
