"""Single-GPU contention guard, an advisory ``flock`` (port of
``pcrlv2_tpu/utils/chiplock.py``).

Two processes training or timing on one card share it, and both numbers
are then garbage.  So the GPU entry points take an exclusive ``flock`` on a
well-known path (``PCRL_CHIP_LOCK``, default ``pcrl_gpu.lock`` in
``tempfile.gettempdir()``: ``$TMPDIR``, else ``/tmp``): the
bench refuses to run while another process holds it (``guard_exclusive``),
trainers warn (``guard_warn``).  ``PCRL_IGNORE_CHIP_LOCK=1`` lets the bench
run anyway.

The lock belongs to the open file description, so it drops when the
process dies (no stale lock), and a holder must release it before another
guard of the same process can take it.  The holder's pid, label and start
time are written into the file for diagnostics; after a crash they may be
stale, the ``flock`` itself never is.
"""

from __future__ import annotations

import fcntl
import json
import os
import tempfile
import time
from typing import Optional

DEFAULT_NAME = "pcrl_gpu.lock"


def lock_path(path: Optional[str] = None) -> str:
    """``path``, else ``PCRL_CHIP_LOCK``, else ``DEFAULT_NAME`` in the
    temporary directory (``$TMPDIR``, else ``/tmp``)."""
    return (path or os.environ.get("PCRL_CHIP_LOCK")
            or os.path.join(tempfile.gettempdir(), DEFAULT_NAME))


class ChipLock:
    """A held lock; ``release`` it (or leave the ``with`` block), or let the
    process's exit drop it."""

    def __init__(self, fd: int, path: str, label: str):
        self._fd = fd
        self.path = path
        self.label = label

    def release(self) -> None:
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def acquire(label: str, path: Optional[str] = None) -> Optional[ChipLock]:
    """Take the lock without waiting: a ``ChipLock``, or None if it cannot
    be taken (``acquire_ex`` says why)."""
    return acquire_ex(label, path)[0]


def acquire_ex(label: str, path: Optional[str] = None) -> tuple[Optional[ChipLock], str]:
    """Like ``acquire``, and why it failed: ``"contended"`` (another holder
    is alive: the GPU is busy) or ``"open-failed: …"`` (the lock file could
    not be opened, for example one of another user's in a sticky ``/tmp``:
    the GPU may well be free)."""
    path = lock_path(path)
    try:
        # 0o666 before the umask: one user's lock file must not turn
        # another user's guard into a PermissionError
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
    except OSError as e:
        return None, f"open-failed: {e}"
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(fd)
        return None, "contended"
    meta = json.dumps({"pid": os.getpid(), "label": label, "since": time.time()}) + "\n"
    try:
        os.ftruncate(fd, 0)
        os.pwrite(fd, meta.encode(), 0)
    except OSError:
        pass  # the metadata is for diagnostics; the flock is held
    return ChipLock(fd, path, label), ""


def holder_info(path: Optional[str] = None) -> dict:
    """What the lock file says of its current or last holder (may be stale)."""
    try:
        with open(lock_path(path)) as f:
            info = json.loads(f.read() or "{}")
    except (OSError, ValueError):
        return {}
    if "since" in info:
        info["held_for_s"] = round(time.time() - float(info["since"]), 1)
    return info


def guard_exclusive(label: str, path: Optional[str] = None) -> ChipLock:
    """Take the lock or raise ``SystemExit`` naming the holder: for
    benchmarks, whose number is garbage on a shared GPU.
    ``PCRL_IGNORE_CHIP_LOCK=1`` skips the guard (the number may be garbage)."""
    if os.environ.get("PCRL_IGNORE_CHIP_LOCK") == "1":
        return ChipLock(os.open(os.devnull, os.O_RDONLY), lock_path(path), label)
    lock, why = acquire_ex(label, path)
    if lock is None:
        if why.startswith("open-failed"):
            raise SystemExit(
                f"REFUSING to run '{label}': could not open the GPU lock file "
                f"{lock_path(path)} ({why}); the GPU may be free: fix or remove that file, "
                "or point PCRL_CHIP_LOCK at a writable path.  To skip the guard set "
                "PCRL_IGNORE_CHIP_LOCK=1.")
        raise SystemExit(
            f"REFUSING to run '{label}': the GPU lock {lock_path(path)} is held by "
            f"{holder_info(path) or 'another process'}; two jobs on one GPU share it and "
            "both numbers are garbage.  Stop the other job or, knowing the number "
            "will be garbage, set PCRL_IGNORE_CHIP_LOCK=1.")
    return lock


def guard_warn(label: str, path: Optional[str] = None) -> Optional[ChipLock]:
    """Take the lock or warn: for trainers, where sharing the GPU is the
    user's decision.  The lock, or None (after a warning) if another process
    holds it or its file cannot be opened."""
    lock, why = acquire_ex(label, path)
    if lock is None:
        if why.startswith("open-failed"):
            print(f"WARNING: could not open the GPU lock file {lock_path(path)} ({why}); "
                  "running unguarded.  The GPU may be free, but fix or remove that file "
                  "so that the guard works again.", flush=True)
        else:
            print(f"WARNING: the GPU lock {lock_path(path)} is held by "
                  f"{holder_info(path) or 'another process'}: this run shares the GPU "
                  "with it and both jobs' timings will be garbage.", flush=True)
    return lock
