"""Raw-DEFLATE compressor stream (a copy of ``tpu_deflate.streams.deflater``,
the analog of the reference library's ``DeflaterOutputStream``).

A sliding ``[history][data]`` buffer, one strategy decision per
lookahead-full chunk, default 64 KiB lookahead / 32 KiB history /
RLE_DYNAMIC strategy, explicit ``finish``/``close`` state discipline
(write-after-finish raises), final block emitted with bfinal and the output
zero-padded to a byte boundary. An optional preset dictionary primes the
history window (the encode side of zlib FDICT).
"""

from __future__ import annotations

import numpy as np

from ..codec import deflate_encode as enc
from ..kernels.bitio import BitWriter

MAX_HISTORY_CAPACITY = 32 * 1024
DEFAULT_LOOKAHEAD = 64 * 1024


class Deflater:
    """Streaming raw-DEFLATE encoder writing to ``sink`` (``write(bytes)``)."""

    def __init__(
        self,
        sink,
        *,
        lookahead: int = DEFAULT_LOOKAHEAD,
        history: int = MAX_HISTORY_CAPACITY,
        strategy: enc.Strategy | None = None,
        preset_dictionary: bytes | None = None,
    ):
        if lookahead < 1 or history < 0 or history > MAX_HISTORY_CAPACITY:
            raise ValueError("Invalid capacities")
        self._sink = sink
        self._strategy = strategy if strategy is not None else enc.RLE_DYNAMIC
        self._lookahead = lookahead
        self._history_limit = history
        self._buf = np.zeros(history + max(lookahead, history), dtype=np.uint8)
        self._hist_start = 0
        self._hist_len = 0
        self._data_len = 0
        self._writer = BitWriter()
        self._finished = False
        self._closed = False
        if preset_dictionary:
            d = np.frombuffer(preset_dictionary, dtype=np.uint8)[-history:] if history else None
            if d is not None and d.size:
                self._buf[: d.size] = d
                self._hist_len = d.size

    # ------------------------------------------------------------------

    def _check_open(self):
        if self._finished or self._closed:
            raise ValueError("Stream already ended")

    def write(self, data) -> int:
        self._check_open()
        arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data.astype(np.uint8, copy=False)
        off = 0
        while off < arr.size:
            if self._data_len >= self._lookahead:
                self._flush_chunk(False)
            n = min(arr.size - off, self._lookahead - self._data_len)
            start = self._hist_start + self._hist_len + self._data_len
            self._buf[start : start + n] = arr[off : off + n]
            off += n
            self._data_len += n
        return len(data)

    def write_byte(self, b: int) -> None:
        """Single-byte write (≙ ``DeflaterOutputStream.write(int b)``)."""
        self.write(bytes([b & 0xFF]))

    def finish(self) -> None:
        """Emit the final block (even if empty) and byte-align the output."""
        self._check_open()
        self._flush_chunk(True)
        self._writer.align_to_byte()
        self._drain(final=True)
        self._finished = True

    def close(self) -> None:
        if not self._finished and not self._closed:
            self.finish()
        self._closed = True

    @property
    def bits_written(self) -> int:
        return self._writer.bit_position

    # ------------------------------------------------------------------

    def _flush_chunk(self, is_final: bool) -> None:
        end = self._hist_start + self._hist_len + self._data_len
        chunk = self._buf[self._hist_start : end]
        plan = self._strategy.plan(chunk, self._hist_len)
        plan.emit(self._writer, is_final)
        self._drain(final=False)

        # Slide the history window: the last min(history_limit, hist+data)
        # bytes become the new history at the buffer front.
        new_hist = min(self._history_limit, self._hist_len + self._data_len)
        if new_hist:
            src = end - new_hist
            self._buf[:new_hist] = self._buf[src:end]
        self._hist_start = 0
        self._hist_len = new_hist
        self._data_len = 0

    def _drain(self, final: bool) -> None:
        """Move whole bytes from the bit writer to the sink."""
        # BitWriter keeps at most 7 unflushed bits; its byte buffer is
        # internal, so swap it out wholesale.
        data = bytes(self._writer._buf)
        if data:
            self._sink.write(data)
            self._writer._buf.clear()
        if final and self._writer._nparital:
            raise AssertionError("finish() must byte-align first")
