"""zlib (RFC 1950) container streams (a copy of
``tpu_deflate.streams.zlib_stream``).

``ZlibWriter``: 2-byte header via the metadata record, running Adler-32
over the plaintext, big-endian trailer. ``ZlibReader``: header parse,
raw-DEFLATE payload with the end-exactly contract, Adler-32 verification
at the end. Preset dictionaries (FDICT) work on both sides: the writer
records the dictionary's Adler-32 in the header, the reader checks the id
and primes the LZ77 window.
"""

from __future__ import annotations

from ..codec import deflate_encode as enc
from ..format.errors import DataFormatError, Reason, raise_unexpected_end
from ..format.zlib_meta import ZlibMetadata
from ..kernels.checksum import adler32
from .deflater import Deflater
from .inflater import InflaterReader


class ZlibWriter:
    def __init__(
        self,
        sink,
        metadata: ZlibMetadata | None = None,
        *,
        strategy: enc.Strategy | None = None,
        preset_dictionary: bytes | None = None,
        lookahead: int = 64 * 1024,
        history: int = 32 * 1024,
    ):
        self._sink = sink
        if preset_dictionary is not None:
            dict_id = adler32(preset_dictionary)
            if metadata is None:
                metadata = ZlibMetadata(preset_dictionary=dict_id)
            elif metadata.preset_dictionary != dict_id:
                raise ValueError("metadata preset dictionary id does not match dictionary")
        meta = metadata if metadata is not None else ZlibMetadata()
        meta.write(sink)
        self._deflater = Deflater(
            sink,
            strategy=strategy,
            lookahead=lookahead,
            history=history,
            preset_dictionary=preset_dictionary,
        )
        self._adler = 1
        self._finished = False

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("Stream already ended")
        self._deflater.write(data)
        self._adler = adler32(data, self._adler)
        return len(data)

    def finish(self) -> None:
        if self._finished:
            raise ValueError("Stream already ended")
        self._deflater.finish()
        self._sink.write(self._adler.to_bytes(4, "big"))
        self._finished = True

    def close(self) -> None:
        if not self._finished:
            self.finish()


class ZlibReader:
    def __init__(self, source, *, preset_dictionary: bytes | None = None):
        self._source = source
        self._metadata = ZlibMetadata.read(source)
        if self._metadata.preset_dictionary is not None:
            if preset_dictionary is None:
                raise ValueError("stream requires a preset dictionary")
            if adler32(preset_dictionary) != self._metadata.preset_dictionary:
                raise DataFormatError(
                    Reason.HEADER_CHECKSUM_MISMATCH,
                    "Preset dictionary id mismatch",
                )
        self._inflater = InflaterReader(
            source,
            end_exactly=True,
            preset_dictionary=preset_dictionary
            if self._metadata.preset_dictionary is not None
            else None,
        )
        self._adler = 1
        self._eof = False

    @property
    def metadata(self) -> ZlibMetadata:
        return self._metadata

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            want = (n - len(out)) if n >= 0 else (1 << 20)
            chunk = self._inflater.read(want)
            if chunk:
                out += chunk
                self._adler = adler32(chunk, self._adler)
                continue
            if not self._eof:
                tail = self._inflater.detach()
                trailer = tail.read(4)
                if len(trailer) < 4:
                    raise_unexpected_end()
                if int.from_bytes(trailer, "big") != self._adler:
                    raise DataFormatError(
                        Reason.DECOMPRESSED_CHECKSUM_MISMATCH,
                        "Decompression Adler-32 mismatch",
                    )
                self._eof = True
            break
        return bytes(out)

    def close(self) -> None:
        self._inflater.close()
