"""Atomic file commit: write to a temp file, then rename.

Copy of ``dsi_tpu/utils/atomicio.py`` (``atomic_write`` with the
last-writer-wins rename only, ``fsync_dir``, ``write_bytes_durable``,
``read_bytes_verified``, ``reap_tmp_files``), kept here so the port
imports nothing of ``dsi_tpu``.  A writer that dies mid-write leaves no
partial ``mr-out-*`` file; the checkpoint store (``ckpt/store.py``) and
the tracer (``obs/trace.py``) commit through the durable path.
"""

from __future__ import annotations

import os
import tempfile
import zlib
from contextlib import contextmanager
from typing import IO, Iterator, Optional


@contextmanager
def atomic_write(path: str, mode: str = "w") -> Iterator[IO]:
    """Open a temp file in the destination directory; fsync and rename it
    onto ``path`` on successful exit.  On exception the temp file is
    removed and nothing is committed."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    # The ".tmp-" prefix keeps uncommitted temp files out of "mr-out*" globs.
    fd, tmp = tempfile.mkstemp(prefix=".tmp-" + os.path.basename(path) + ".",
                               dir=d)
    # Text mode pins utf-8: output bytes must not depend on the host locale.
    f = os.fdopen(fd, mode, encoding=None if "b" in mode else "utf-8")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.rename(tmp, path)
    except BaseException:
        try:
            f.close()
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a just-created/renamed entry survives power
    loss: rename makes the new name visible, but only the directory
    fsync makes the entry durable.  ``atomic_write`` alone shipped with
    this gap (as did the journal's create-then-append); the checkpoint
    manifests and the control-plane journal both close it through this
    one helper.  Best-effort: some filesystems refuse O_RDONLY
    directory fsync, and losing the optimization there must not fail
    the commit."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_bytes_durable(path: str, data: bytes) -> int:
    """The shared durable-write path for checkpoint payloads and
    manifests: ``atomic_write`` (temp + file fsync + rename) + a CRC32
    sidecar (``<path>.crc32``) + parent-dir fsync.  Returns the CRC32.

    The sidecar is written AFTER the payload commits: a crash between
    the two leaves a payload without a sidecar, which
    :func:`read_bytes_verified` treats exactly like a torn payload —
    invisible, fall back to the previous generation."""
    crc = zlib.crc32(data)
    with atomic_write(path, "wb") as f:
        f.write(data)
    with atomic_write(path + ".crc32", "w") as f:
        f.write(f"{crc:08x}\n")
    fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
    return crc


def read_bytes_verified(path: str) -> Optional[bytes]:
    """Read ``path`` and verify it against its CRC32 sidecar; None when
    the file or sidecar is missing, unparsable, or mismatched — the
    loader's cue to fall back to an older generation rather than trust
    bytes that survived a rename but not the crash."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        with open(path + ".crc32", encoding="ascii") as f:
            want = int(f.read().strip(), 16)
    except (OSError, ValueError):
        return None
    if zlib.crc32(data) != want:
        return None
    return data


def reap_tmp_files(directory: str, prefix: str = ".tmp-") -> int:
    """Remove ``.tmp-*`` orphans left by writers killed mid-commit
    (``atomic_write``'s temp prefix).  Safe in a quiesced directory by
    construction: a live writer's temp file disappears at rename, so
    anything still named ``.tmp-*`` once the writers are dead is
    garbage.  In a directory SHARED by live writers (mrrun's trace dir),
    pass a narrower ``prefix`` — ``.tmp-<target-name>.`` — so one
    process only reaps its own orphans, never a committing sibling's
    in-flight temp.  Returns the number removed."""
    n = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        if name.startswith(prefix):
            try:
                os.remove(os.path.join(directory, name))
                n += 1
            except OSError:
                pass
    return n
