"""One-shot in-memory API: ``compress(bytes) -> bytes`` and
``decompress(bytes) -> bytes``.

Mirrors BZ2_bzBuffToBuffCompress/Decompress semantics (reference
bzlib.c:1309-1410): a single whole stream per call, with distinct error
classes for corruption vs truncation.  The block codec backend is pluggable:
``backend="oracle"`` uses the NumPy reference implementation; the JAX device
engine registers itself as ``backend="tpu"`` (``enable_tpu_backend()``; the
name is historical, the engine runs on whatever device JAX has).
"""
from __future__ import annotations

import numpy as np

from . import constants as C
from . import crc as _crc
from . import rle1 as _rle1
from .bitstream import BitReader, BitWriter, splice
from .oracle import block as _oblock


class BZ2Error(Exception):
    code = C.BZ_DATA_ERROR


class DataError(BZ2Error):
    """Stream is corrupt (BZ_DATA_ERROR)."""
    code = C.BZ_DATA_ERROR


class DataErrorMagic(DataError):
    """Not a bzip2 stream (BZ_DATA_ERROR_MAGIC)."""
    code = C.BZ_DATA_ERROR_MAGIC


class UnexpectedEOF(BZ2Error):
    """Stream truncated mid-block (BZ_UNEXPECTED_EOF)."""
    code = C.BZ_UNEXPECTED_EOF


_BLOCK_ENCODERS = {"oracle": None}  # filled lazily / by engine registration


def _native_available() -> bool:
    try:
        from . import native
        return native.available()
    except Exception:
        return False


def _oracle_encode_blocks(blocks, level):
    return [_oblock.encode_block(b) for b in blocks]


def register_block_encoder(name: str, fn) -> None:
    """Register a batched block encoder: fn(list[RLE1Block], level) ->
    list[(uint8 array, nbits)] of per-block bit payloads.

    Every backend is wrapped with the exactly-periodic origPtr corrector
    (periodic.patch_payloads): the sorters' last-in-class tie slot matches
    stock bzip2 on all regular periodic families, and the corrector closes
    the adversarial residue so bit-exactness vs stock is unconditional."""

    def wrapped(blocks, level, _fn=fn):
        from . import periodic
        return periodic.patch_payloads(_fn(blocks, level), blocks, level)

    _BLOCK_ENCODERS[name] = wrapped


def _native_encode_blocks(blocks, level):
    """Blocks are independent by format design (SURVEY §2.3 block-DP axis)
    and the C++ encoder is thread-safe (thread_local scratch only, GIL
    released), so multi-core hosts encode them in a thread pool.  The
    reference is single-threaded (bzip2.c's whole main loop); this is the
    host-side analogue of the device engine's block-data-parallelism.
    BZ2TPU_HOST_WORKERS pins the width (default: up to 8, one per CPU)."""
    import os
    from . import native
    nw = int(os.environ.get("BZ2TPU_HOST_WORKERS", "0")) \
        or min(8, os.cpu_count() or 1)
    if nw > 1 and len(blocks) > 1:
        import concurrent.futures as _cf
        with _cf.ThreadPoolExecutor(
                max_workers=min(nw, len(blocks))) as ex:
            payloads = list(ex.map(
                lambda b: native.encode_block(b.data, b.in_use, b.crc),
                blocks))
    else:
        payloads = [native.encode_block(b.data, b.in_use, b.crc)
                    for b in blocks]
    return [(np.frombuffer(p, np.uint8), nbits) for p, nbits in payloads]


register_block_encoder("oracle", _oracle_encode_blocks)
_default_backend = "oracle"
if _native_available():
    # the C++ encoder is bit-identical to the oracle and ~100x faster; it
    # is the default for non-TPU use (enable_tpu_backend() overrides)
    register_block_encoder("native", _native_encode_blocks)
    _default_backend = "native"


def set_default_backend(name: str) -> None:
    global _default_backend
    _default_backend = name


def get_default_backend() -> str:
    return _default_backend


def compress(data, level: int = 9, backend: str | None = None) -> bytes:
    """Compress ``data`` into a complete single .bz2 stream."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    backend = backend or _default_backend
    encoder = _BLOCK_ENCODERS[backend]
    if encoder is None:
        raise ValueError(f"unknown backend {backend!r}")

    blocks = _rle1.encode_blocks(data, level)
    payloads = encoder(blocks, level) if blocks else []

    w = BitWriter()
    w.write(C.HDR_B, 8)
    w.write(C.HDR_Z, 8)
    w.write(C.HDR_h, 8)
    w.write(C.HDR_0 + level, 8)
    header, hbits = w.getvalue()
    parts = [(header, hbits)]
    parts.extend(payloads)
    eos = BitWriter()
    eos.write(C.EOS_MAGIC, 48)
    eos.write(_crc.combine_block_crcs([b.crc for b in blocks]), 32)
    parts.append(eos.getvalue())
    buf, _ = splice(parts)
    return buf.tobytes()


def decompress(data, multi_stream: bool = False, backend: str | None = None) -> bytes:
    """Decompress one .bz2 stream (or all concatenated streams if
    ``multi_stream``).  Verifies both CRC layers.

    Raises DataErrorMagic / DataError / UnexpectedEOF exactly where the
    reference returns the corresponding BZ_* codes.  backend: "native"
    (default when built) or "oracle".
    """
    out, _ = decompress_with_tail(data, multi_stream=multi_stream, backend=backend)
    return out


def decompress_with_tail(data, multi_stream: bool = False,
                         backend: str | None = None) -> tuple[bytes, int]:
    """Like decompress(); also returns the byte offset where parsing stopped
    (start of any trailing garbage / next stream)."""
    if backend is None:
        backend = "native" if _native_available() else "oracle"
    if backend in ("device", "tpu"):
        # device decode path (bzip2_tpu/decoder.py): device Huffman/MTF^-1/
        # RLE2/inverse-BWT/RLE1^-1/CRC with host light-parse; anomalous
        # batches are healed on the host per batch.
        from .decoder import default_decoder
        return default_decoder().decompress_with_tail(
            data, multi_stream=multi_stream)
    if backend == "native":
        from . import native
        out, consumed, rc = native.decompress(data, multi_stream=multi_stream)
        if rc == native.BZT_OK:
            return out, consumed
        if rc == native.BZT_DATA_ERROR_MAGIC:
            raise DataErrorMagic("bad stream header")
        if rc == native.BZT_UNEXPECTED_EOF:
            raise UnexpectedEOF("stream truncated")
        raise DataError(f"corrupt stream (native rc={rc})")
    buf = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else data
    r = BitReader(buf)
    chunks: list[bytes] = []
    streams_done = 0
    while True:
        try:
            _decompress_stream(r, chunks)
        except EOFError:
            raise UnexpectedEOF("stream truncated") from None
        except DataErrorMagic:
            if streams_done and multi_stream:
                # Trailing garbage after at least one complete stream is
                # tolerated (bzip2.c:531-542); report where it starts.
                break
            raise
        streams_done += 1
        # Streams are byte-aligned; skip pad bits to the next byte.
        r.pos += r.byte_align_remainder()
        if not multi_stream or r.pos >= r.nbits:
            break
    return b"".join(chunks), (r.pos + 7) // 8


def _decompress_stream(r: BitReader, chunks: list) -> None:
    pos0 = r.pos
    try:
        hb, hz, hh, hl = r.read(8), r.read(8), r.read(8), r.read(8)
    except EOFError:
        raise DataErrorMagic("truncated header") from None
    if (hb, hz, hh) != (C.HDR_B, C.HDR_Z, C.HDR_h) or not (C.HDR_0 + 1 <= hl <= C.HDR_0 + 9):
        r.pos = pos0
        raise DataErrorMagic("bad stream header")
    level = hl - C.HDR_0

    combined = 0
    n_blocks = 0
    while True:
        magic = r.read(48)
        if magic == C.EOS_MAGIC:
            stored_combined = r.read(32)
            if stored_combined != combined:
                raise DataError("combined CRC mismatch")
            return
        if magic != C.BLOCK_MAGIC:
            raise DataError("bad block magic")
        try:
            stored_crc, raw = _oblock.decode_block_body(r, level)
        except _oblock.DataError as e:
            raise DataError(str(e)) from e
        calc = _crc.crc32(raw)
        if calc != stored_crc:
            raise DataError("block CRC mismatch")
        combined = (((combined << 1) | (combined >> 31)) & 0xFFFFFFFF) ^ stored_crc
        chunks.append(raw.tobytes())
        n_blocks += 1
