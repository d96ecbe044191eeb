"""The host core this port shares with ``tpu_deflate``, in one place.

These modules import no JAX: the C core (``native``: the LZ77 token
resolve, and the member encoder that writes the streams the port reads),
the member splitter, the error type and the pure-Python host
decoder. A script that drives the port reaches them here and names no
module of the JAX package itself.
"""

from tpu_deflate import gzip_decompress as host_gzip_decompress
from tpu_deflate import native
from tpu_deflate.codec.decode_jax import split_members
from tpu_deflate.format.errors import DataFormatError

__all__ = [
    "DataFormatError",
    "host_gzip_decompress",
    "native",
    "split_members",
]
