"""Member catalog: seekable decode and checkpoint/resume (a copy of
``tpu_deflate.catalog``).

The TD stream profile embeds a bgzf-style size subfield in every member
header, so any profile stream doubles as its own index: a catalog maps
uncompressed byte ranges to members without decoding anything. This
enables:

- ``read_range(a, b)``: decode only the members covering [a, b) (random
  access at member granularity);
- ``resume_point(done_bytes)``: the (input offset, output offset) pair
  from which an interrupted decode job restarts;
- failure isolation: ``decode_all(on_error="skip")`` decodes every member
  independently and reports bad members instead of failing the whole job.

The members decode on the card (``decode_v2.gzip_decompress_v2``, the
decode of ``engine.decompress``), the members a call needs in one stream;
with ``engine="host"`` each member decodes in the C core
(``native.inflate_raw``, ``native.crc32``), the reference's host catalog.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native
from .codec.decode_np import MemberIndex, split_members
from .format.errors import DataFormatError, OutputCapacityError, Reason


@dataclass
class MemberEntry:
    index: MemberIndex
    out_start: int  # uncompressed offset of this member's first byte

    @property
    def out_end(self) -> int:
        return self.out_start + self.index.isize


class MemberCatalog:
    """Index over a TD-profile gzip stream (or any stream after a one-time
    host scan)."""

    def __init__(self, data: bytes, *, engine: str = "cuda"):
        from . import _card

        self._device = _card(engine)
        self._data = data
        buf = np.frombuffer(data, dtype=np.uint8)
        members = split_members(buf)
        if members is None:
            raise ValueError(
                "stream has no TD member index; re-encode with the profile "
                "encoder or use the streaming decoder"
            )
        self.entries: list[MemberEntry] = []
        off = 0
        for m in members:
            self.entries.append(MemberEntry(m, off))
            off += m.isize
        self.total_uncompressed = off

    # ------------------------------------------------------------------

    def _decode_member(self, e: MemberEntry) -> bytes:
        payload = self._data[e.index.payload_start : e.index.end - 8]
        try:
            out, _ = native.inflate_raw(payload, e.index.isize + 1)
        except OutputCapacityError:
            raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "size mismatch")
        if len(out) != e.index.isize:
            raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "size mismatch")
        if native.crc32(out) != e.index.crc32:
            raise DataFormatError(
                Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression CRC-32 mismatch"
            )
        return out

    def _decode(self, entries: list[MemberEntry]) -> bytes:
        """The members ``entries`` (consecutive) decoded, end to end."""
        if not entries:
            return b""
        if self._device is None:
            return b"".join(self._decode_member(e) for e in entries)
        from .codec.decode_v2 import gzip_decompress_v2

        span = self._data[entries[0].index.start : entries[-1].index.end]
        return gzip_decompress_v2(span, device=self._device)

    def read_range(self, start: int, end: int) -> bytes:
        """Decode exactly the uncompressed byte range [start, end)."""
        start = max(0, start)
        end = min(end, self.total_uncompressed)
        if end <= start:
            return b""
        span = [e for e in self.entries if e.out_end > start and e.out_start < end]
        first = span[0].out_start
        return self._decode(span)[start - first : end - first]

    def resume_point(self, done_bytes: int) -> tuple[int, int]:
        """(compressed offset, uncompressed offset) of the first member not
        fully contained in the already-produced prefix ``done_bytes`` —
        restart an interrupted job from here."""
        for e in self.entries:
            if e.out_end > done_bytes:
                return e.index.start, e.out_start
        return len(self._data), self.total_uncompressed

    def decode_all(self, *, on_error: str | None = None, config=None):
        """Decode every member; with on_error='skip', bad members yield
        b'' placeholders and are reported in the second return value.

        ``config`` (a DecoderConfig, or an object holding one as
        ``.decoder``) supplies the default failure-isolation policy."""
        if on_error is None:
            from .config import DecoderConfig

            cfg = DecoderConfig() if config is None else getattr(config, "decoder", config)
            on_error = cfg.on_error
        try:
            return self._decode(self.entries), []
        except (DataFormatError, ValueError):
            if on_error == "raise":
                raise
        outs: list[bytes] = []
        bad: list[int] = []
        for i, e in enumerate(self.entries):
            try:
                outs.append(self._decode([e]))
            except (DataFormatError, ValueError):
                outs.append(b"")
                bad.append(i)
        return b"".join(outs), bad
