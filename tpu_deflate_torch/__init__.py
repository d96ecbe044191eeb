"""PyTorch + CUDA port of tpu_deflate's device decode.

``tpu_deflate/`` (JAX + Pallas for the TPU) is the unchanged reference;
this package mirrors its layout (``codec/``, ``engine.py``, ``csrc/``)
and imports its JAX-free modules (``format/``, ``native/``,
``codec/decode_jax``, ``codec/profile``, ``kernels/checksum``,
``config``, ``streams/``) instead of copying them. It imports ``torch``
and never ``jax``.
"""
