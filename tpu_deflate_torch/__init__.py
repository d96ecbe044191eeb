"""PyTorch + CUDA port of tpu_deflate's device decode.

``tpu_deflate/`` (JAX + Pallas for the TPU) is the unchanged reference;
this package mirrors its layout (``codec/``, ``format/``, ``kernels/``,
``engine.py``, ``config.py``, ``csrc/`` for the CUDA kernels) and keeps
its own copies of the JAX-free pieces it needs. It imports ``torch`` and
never ``jax``, and nothing of ``tpu_deflate``; ``native.py`` binds the
shared C core ``native/deflate_core.c`` on its own.
"""
