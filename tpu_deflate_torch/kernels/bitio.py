"""LSB-first bit stream packing and reading on the host (a copy of
``tpu_deflate.kernels.bitio``).

DEFLATE's bit order (RFC 1951 §3.1.1): bits fill each byte starting at the
least-significant bit; Huffman codes are stored most-significant-code-bit
first (so encoders emit bit-reversed codes), everything else (extra bits,
lengths) value-LSB-first.

``pack_bits`` materializes every token's (value, nbits) pair and scatters
all bits in one vectorized pass; ``BitWriter`` and ``CountingBitWriter``
are the host strategy encoder's sinks; ``BitReader`` is the serial
inflater's source, which reads ahead of what it consumes and gives the
over-read bytes back (``detach``) so a container reader can go on at the
first byte after the DEFLATE payload.
"""

from __future__ import annotations

import numpy as np

from ..format.errors import DataFormatError


def pack_bits(values: np.ndarray, nbits: np.ndarray, bit_offset: int = 0) -> tuple[np.ndarray, int]:
    """Pack tokens LSB-first into a byte array.

    values: uint64 array, token i contributes its low nbits[i] bits.
    bit_offset: number of already-occupied bits in the first output byte
        (the caller ORs our first byte onto its partial byte).

    Returns (bytes as uint8 array, total_bits) where total_bits includes
    bit_offset; the final byte is zero-padded.
    """
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    assert values.shape == nbits.shape
    total = int(nbits.sum()) + bit_offset
    if total == 0:
        return np.zeros(0, dtype=np.uint8), 0
    ends = np.cumsum(nbits)
    starts = ends - nbits + bit_offset
    nbytes = (total + 7) // 8

    # Expand every token into its individual bits:
    #   global bit index = starts[tok] + within
    #   bit value        = (values[tok] >> within) & 1
    tok_idx = np.repeat(np.arange(values.size), nbits)
    within = np.arange(tok_idx.size, dtype=np.int64) - np.repeat(starts - bit_offset, nbits)
    bitvals = ((values[tok_idx] >> within.astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
    positions = np.repeat(starts, nbits) + within

    bits = np.zeros(nbytes * 8, dtype=np.uint8)
    bits[positions] = bitvals
    return np.packbits(bits, bitorder="little"), total


def unpack_to_bits(data: np.ndarray) -> np.ndarray:
    """Byte array -> uint8 bit array, LSB-first per byte."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), bitorder="little")


class BitWriter:
    """Streaming LSB-first bit sink accumulating into a bytearray.

    Implements the framework's ``BitOutput`` contract (analog of the
    reference's ``comp/BitOutputStream.java`` interface): ``write_bits`` and
    ``bit_position``. Accepts both scalar writes (header emission) and bulk
    vectorized token writes (block bodies).
    """

    def __init__(self):
        self._buf = bytearray()
        self._partial = 0  # bits not yet flushed to _buf (value)
        self._nparital = 0  # number of valid bits in _partial, in [0, 8)
        self._total_bits = 0

    @property
    def bit_position(self) -> int:
        """Total bits written so far (mod 8 gives the start alignment)."""
        return self._total_bits

    def write_bits(self, value: int, nbits: int) -> None:
        assert 0 <= nbits <= 57
        assert nbits == 57 or 0 <= value < (1 << nbits)
        self._partial |= value << self._nparital
        self._nparital += nbits
        self._total_bits += nbits
        while self._nparital >= 8:
            self._buf.append(self._partial & 0xFF)
            self._partial >>= 8
            self._nparital -= 8

    def write_token_array(self, values: np.ndarray, nbits: np.ndarray) -> None:
        """Bulk write: vectorized pack of many (value, nbits) tokens."""
        packed, total = pack_bits(values, nbits, bit_offset=self._nparital)
        if total == 0:
            return
        nb = np.asarray(nbits, dtype=np.int64).sum()
        if packed.size:
            packed = packed.copy()
            packed[0] |= self._partial
        whole, rem = divmod(self._nparital + int(nb), 8)
        self._buf += packed[:whole].tobytes()
        self._partial = int(packed[whole]) if rem else 0
        self._nparital = rem
        self._total_bits += int(nb)

    def write_bytes(self, data: bytes) -> None:
        """Byte-aligned bulk write (caller must be at a byte boundary)."""
        assert self._nparital == 0
        self._buf += data
        self._total_bits += 8 * len(data)

    def align_to_byte(self) -> None:
        """Zero-pad to the next byte boundary."""
        if self._nparital:
            pad = 8 - self._nparital
            self.write_bits(0, pad)

    def getvalue(self) -> bytes:
        """Bytes written so far; any partial byte is zero-padded."""
        out = bytes(self._buf)
        if self._nparital:
            out += bytes([self._partial])
        return out


class CountingBitWriter:
    """Null sink that only counts bits.

    Analog of ``comp/CountingBitOutputStream.java:14-33`` — lets a Decision
    cost itself without materializing output.
    """

    def __init__(self, start_position: int = 0):
        self._total_bits = start_position

    @property
    def bit_position(self) -> int:
        return self._total_bits

    def write_bits(self, value: int, nbits: int) -> None:
        self._total_bits += nbits

    def write_token_array(self, values, nbits) -> None:
        self._total_bits += int(np.asarray(nbits, dtype=np.int64).sum())

    def write_bytes(self, data: bytes) -> None:
        self._total_bits += 8 * len(data)

    def align_to_byte(self) -> None:
        self._total_bits = (self._total_bits + 7) // 8 * 8


class BitReader:
    """LSB-first bit reader over an underlying byte source.

    Mirrors the *semantics* of the reference's buffered dual-register reader
    (``decomp/Open.java:137-192``): tracks exactly how many whole bytes have
    been consumed from the underlying source so the ``end_exactly`` detach
    contract can reposition the source at the first byte after the DEFLATE
    payload (a partially consumed byte counts as fully consumed,
    ``decomp/Open.java:113-124``).

    The source is any object with ``read(n) -> bytes``.
    """

    def __init__(self, source, buffer_size: int = 16 * 1024):
        self._source = source
        self._buffer_size = max(1, buffer_size)
        self._chunk = b""
        self._chunk_pos = 0  # bytes of _chunk already moved into the bit register
        self._reg = 0  # bit register, LSB = next bit
        self._reg_bits = 0
        self._consumed_chunks = 0  # bytes fetched from source in previous chunks
        self._mark_callback = None  # called right before each source read
        self._source_eof = False

    # -- internals ---------------------------------------------------------

    def _fetch(self, *, raise_on_eof: bool = True) -> bool:
        if self._source_eof:
            if raise_on_eof:
                raise DataFormatError.unexpected_end()
            return False
        if self._mark_callback is not None:
            self._mark_callback()
        data = self._source.read(self._buffer_size)
        if not data:
            self._source_eof = True
            if raise_on_eof:
                raise DataFormatError.unexpected_end()
            return False
        self._consumed_chunks += len(self._chunk)
        self._chunk = data
        self._chunk_pos = 0
        return True

    def _refill(self, need: int, *, raise_on_eof: bool = True) -> None:
        while self._reg_bits < need:
            if self._chunk_pos >= len(self._chunk):
                if not self._fetch(raise_on_eof=raise_on_eof):
                    return
            take = min((63 - self._reg_bits) // 8 + 1, len(self._chunk) - self._chunk_pos)
            take = max(take, 1)
            chunk = self._chunk[self._chunk_pos : self._chunk_pos + take]
            self._reg |= int.from_bytes(chunk, "little") << self._reg_bits
            self._reg_bits += 8 * take
            self._chunk_pos += take

    # -- public API --------------------------------------------------------

    def set_mark_callback(self, cb) -> None:
        self._mark_callback = cb

    def read_bits(self, nbits: int) -> int:
        """Read nbits (0..32) LSB-first; raises UNEXPECTED_END_OF_STREAM."""
        if nbits == 0:
            return 0
        self._refill(nbits)
        result = self._reg & ((1 << nbits) - 1)
        self._reg >>= nbits
        self._reg_bits -= nbits
        return result

    def peek_bits_upto(self, nbits: int) -> tuple[int, int]:
        """Best-effort peek: returns (value, available) without consuming.

        available may be < nbits at end of stream; missing high bits are 0.
        Never raises on EOF — callers decide whether short data is an error.
        """
        self._refill(nbits, raise_on_eof=False)
        avail = min(self._reg_bits, nbits)
        return self._reg & ((1 << nbits) - 1), avail

    def skip_bits(self, nbits: int) -> None:
        assert nbits <= self._reg_bits
        self._reg >>= nbits
        self._reg_bits -= nbits

    def align_to_byte(self) -> None:
        drop = self._reg_bits % 8
        if drop:
            self._reg >>= drop
            self._reg_bits -= drop

    @property
    def buffered_bits(self) -> int:
        return self._reg_bits

    def read_aligned_bytes(self, n: int) -> bytes:
        """Read n whole bytes (must be byte-aligned). Used by stored blocks."""
        assert self._reg_bits % 8 == 0
        out = bytearray()
        # Drain the register first.
        while self._reg_bits >= 8 and len(out) < n:
            out.append(self._reg & 0xFF)
            self._reg >>= 8
            self._reg_bits -= 8
        # Then copy straight from the chunk / source.
        while len(out) < n:
            if self._chunk_pos >= len(self._chunk):
                self._fetch()
            take = min(n - len(out), len(self._chunk) - self._chunk_pos)
            out += self._chunk[self._chunk_pos : self._chunk_pos + take]
            self._chunk_pos += take
        return bytes(out)

    @property
    def consumed_bytes(self) -> int:
        """Whole bytes consumed from the source, counting a partially
        consumed byte as consumed (the reference's detach arithmetic,
        ``decomp/Open.java:117-120``)."""
        return self._consumed_chunks + self._chunk_pos - self._reg_bits // 8

    @property
    def bit_position(self) -> int:
        """Exact number of bits consumed from the source so far."""
        return (self._consumed_chunks + self._chunk_pos) * 8 - self._reg_bits

    @property
    def overread_bytes(self) -> int:
        """Bytes fetched from the source beyond ``consumed_bytes``."""
        return self._consumed_chunks + len(self._chunk) - self.consumed_bytes

    def detach(self) -> bytes:
        """End bit-level reading; return buffered-but-unconsumed bytes.

        A partially consumed byte is dropped (counts as consumed), matching
        the reference's detach arithmetic. After this the underlying source
        continues from where the reader over-read to; the returned bytes are
        logically *before* the source's current position.
        """
        self.align_to_byte()
        whole = bytearray()
        while self._reg_bits >= 8:
            whole.append(self._reg & 0xFF)
            self._reg >>= 8
            self._reg_bits -= 8
        whole += self._chunk[self._chunk_pos :]
        self._chunk = b""
        self._chunk_pos = 0
        self._reg = 0
        self._reg_bits = 0
        return bytes(whole)
