"""Markable file stream (a copy of ``tpu_deflate.streams.markable``, the
analog of the reference library's ``MarkableFileInputStream``).

mark()/reset() over a seekable file. The containers here replay their
buffered tail instead (``InflaterReader.detach``); this class is for
callers that want the mark/reset semantics on plain files.
"""

from __future__ import annotations

import io


class MarkableFileStream:
    """File-backed stream with mark()/reset() via seek."""

    def __init__(self, path_or_file):
        if isinstance(path_or_file, (str, bytes)):
            self._f = open(path_or_file, "rb")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
            self._f.seek(0, io.SEEK_CUR)  # must be seekable
        self._mark = 0

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n)

    def markSupported(self) -> bool:  # noqa: N802 (java-parity name)
        return True

    def mark(self, _readlimit: int = 0) -> None:
        self._mark = self._f.tell()

    def reset(self) -> None:
        self._f.seek(self._mark)

    def skip(self, n: int) -> int:
        pos = self._f.tell()
        self._f.seek(n, io.SEEK_CUR)
        return self._f.tell() - pos

    def close(self) -> None:
        if self._owns:
            self._f.close()
