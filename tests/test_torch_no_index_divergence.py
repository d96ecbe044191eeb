"""A kept divergence, pinned: on a gzip stream without the TD member index,
the port's ``decode_v2.gzip_decompress_v2`` decodes in the C core
(``native.gzip_decompress_serial``), where the reference's
``gzip_decompress_tpu_v2`` takes its host ``GzipReader``. Three decoders
must give the same bytes or the same Reason on every case: the port's
front door on the CPU, the port's ``GzipReader`` (``gzip_decompress``) and
the reference's ``tpu_deflate.gzip_decompress`` (the reference's
no-index branch). The cases: every ``BAD_VECTORS`` payload in a gzip
member; every ``GOOD_VECTORS`` payload whole, with its trailer cut short,
with a bad CRC, with trailing bytes and as two members; a bad magic, a bad
method, reserved flags, a cut header, an empty input and a bad header
CRC.

A second divergence, pinned beside it: on a TD-indexed member that decodes
to another size than its trailer's and so fails both checks, the device
decodes (the port's front door and the reference's
``gzip_decompress_tpu_v2``) report the size, the host readers the CRC."""

from __future__ import annotations

import zlib

import pytest
import torch

import tpu_deflate as ref
import tpu_deflate_torch as port
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.format.gzip_meta import GzipMetadata

from vectors import BAD_VECTORS, GOOD_VECTORS, bits_to_bytes

HEADER = GzipMetadata().to_bytes()


def member(payload: bytes, out: bytes, header: bytes = HEADER) -> bytes:
    return header + payload + zlib.crc32(out).to_bytes(4, "little") + len(out).to_bytes(4, "little")


def _cases() -> dict:
    cases = {}
    for name, bits, _reason in BAD_VECTORS:
        cases[f"bad_{name}"] = member(bits_to_bytes(bits, "0"), b"")
    for name, bits, hexout in GOOD_VECTORS:
        payload, out = bits_to_bytes(bits, "0"), bytes.fromhex(hexout.replace(" ", ""))
        whole = member(payload, out)
        bad_crc = bytearray(whole)
        bad_crc[-8] ^= 0x01
        cases[f"good_{name}"] = whole
        cases[f"cut_trailer_{name}"] = whole[:-3]
        cases[f"bad_crc_{name}"] = bytes(bad_crc)
        cases[f"trailing_{name}"] = whole + b"\x00xyz"
        cases[f"two_members_{name}"] = whole + member(payload, out)
    good = cases["good_fixed_literals"]
    cases["bad_magic"] = b"\x1f\x8c" + good[2:]
    cases["bad_method"] = good[:2] + b"\x07" + good[3:]
    cases["reserved_flags"] = good[:3] + b"\x20" + good[4:]
    cases["cut_header"] = good[:7]
    cases["empty"] = b""
    crc_header = bytearray(GzipMetadata(has_header_crc=True).to_bytes())
    crc_header[-1] ^= 0xFF
    cases["bad_header_crc"] = member(bits_to_bytes(GOOD_VECTORS[0][1], "0"), b"", bytes(crc_header))
    return cases


CASES = _cases()


def outcome(fn, data: bytes):
    try:
        return "ok", fn(data)
    except ValueError as e:
        return "raise", getattr(getattr(e, "reason", None), "name", type(e).__name__)


def test_case_count():
    assert len(CASES) == len(BAD_VECTORS) + 5 * len(GOOD_VECTORS) + 6 == 89


@pytest.mark.parametrize("name", list(CASES))
def test_three_decoders_agree(name):
    data = CASES[name]
    front_door = outcome(lambda d: pv2.gzip_decompress_v2(d, device=torch.device("cpu")), data)
    host = outcome(lambda d: port.gzip_decompress(d, engine="host"), data)
    assert front_door == host == outcome(ref.gzip_decompress, data)
    assert front_door[0] == "raise" or name.startswith(("good_", "trailing_", "two_members_"))


def test_indexed_member_size_before_crc():
    from tpu_deflate.codec.decode_jax_v2 import gzip_decompress_tpu_v2
    from tpu_deflate_torch.codec.profile import profile_compress_host

    from test_torch_oneshot_card import data_of

    bad = bytearray(profile_compress_host(data_of(30000, seed=7), member_data=8192))
    bad[200] ^= 0x40  # the first member decodes to another size
    data = bytes(bad)
    front_door = outcome(lambda d: pv2.gzip_decompress_v2(d, device=torch.device("cpu")), data)
    assert front_door == outcome(gzip_decompress_tpu_v2, data) == ("raise", "DECOMPRESSED_SIZE_MISMATCH")
    host = outcome(lambda d: port.gzip_decompress(d, engine="host"), data)
    assert host == outcome(ref.gzip_decompress, data) == ("raise", "DECOMPRESSED_CHECKSUM_MISMATCH")
