"""bzip2_tpu — a device-accelerated bzip2 codec framework.

A from-scratch reimplementation of the bzip2 format (byte-compatible with
bzip2/libbzip2 1.0.x streams, including the "accelerated bzip2" 1.0.6x
fork's output) with a JAX/XLA compute path for accelerators (an NVIDIA
H100 today):

* block-data-parallel encoding over ``jax.sharding.Mesh`` (blocks are
  independent by format design),
* vectorized BWT (prefix-doubling sort), MTF/RLE2, matmul group search,
  and device-side bit packing,
* a C++ host runtime for the serial stages (exact-heap Huffman, streaming
  block decode),
* full library surface: one-shot, streaming, file objects, CLI, recover.

Public one-shot API mirrors the stdlib ``bz2`` module.
"""

__version__ = "0.1.0"

from .api import (BZ2Error, DataError, DataErrorMagic, UnexpectedEOF,
                  compress, decompress, decompress_with_tail,
                  get_default_backend, set_default_backend)
from .stream import Compressor as BZ2Compressor
from .stream import Decompressor as BZ2Decompressor
from .tracing import set_verbosity, profile_trace, enable_metrics
from .tracing import collect as collect_metrics


def open(*args, **kwargs):  # noqa: A001  (mirror bz2.open)
    from .file import open as _open
    return _open(*args, **kwargs)


def BZ2File(*args, **kwargs):
    from .file import BZ2TFile
    return BZ2TFile(*args, **kwargs)


def enable_tpu_backend(**engine_kwargs):
    """Register a JAX device ``Engine(**engine_kwargs)`` as the default
    compression backend ("tpu" is the backend's historical name); returns
    the engine."""
    from . import api
    from .engine import Engine

    eng = Engine(**engine_kwargs)
    api.register_block_encoder("tpu", lambda blocks, level: eng.encode_payloads(blocks, level))
    api.set_default_backend("tpu")
    return eng
