"""Atomic file commit: write to a temp file, then rename.

Copy of ``dsi_tpu/utils/atomicio.py:atomic_write`` (last-writer-wins
rename only), kept here so the port imports nothing of ``dsi_tpu``.  A
writer that dies mid-write leaves no partial ``mr-out-*`` file.
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import IO, Iterator


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
