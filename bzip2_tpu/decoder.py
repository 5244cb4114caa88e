"""Device decode engine: batched device block decode with host light-parse.

Mirrors the encode Engine's architecture on the decompress side
(reference: BZ2_decompress, decompress.c:232-866, re-staged as batched
device programs; stage kernels in ops/decode.py):

  host   stream walk + per-block light parse (native bz2tpu_parse_block:
         header fields, tables, selectors, per-50-symbol-group bit
         offsets — the bit-serial, tiny part)
  device Huffman symbol decode (group-parallel canonical-code compare)
         -> MTF^-1 (unrolled list scan) -> RLE2 expansion -> inverse BWT
         (splitter walk) -> RLE1^-1 -> CRC-32 (GF(2) fold)
  host   ordered splice, CRC validation, EOS / combined-CRC handling

Robustness contract: a lane anomaly (walker cap exceeded, RLE1 output
over bucket, CRC mismatch) heals just that block on the host; a parse
error, randomised legacy block, or truncation falls back to the native
host decoder for the member's remainder, so corrupt input yields exactly
the host decoder's clean error codes.  A device runtime failure is not
healed: it propagates to the caller.

The per-block light parses do NOT chase the serial end_bit chain
(reference: GET_BITS's strictly sequential state machine,
decompress.c:103-228): 48-bit block-magic candidates from a vectorized
scan are, with probability 1 - n*2^-48, exactly the real block starts,
so every candidate parses CONCURRENTLY (the native scan releases the
GIL) and the batch assembler merely stitches the futures along the
end_bit chain — speculative chunked decode with magic resync, the
block-grain realization of SURVEY's C10 row.

Why the within-block length chase stays on the host (a deliberate
design decision, not a gap): a device chase would be one lane per block
stepping ~800k serial while_loop iterations — orders of magnitude worse
than the chip's batch parallelism can pay for — and the classic
GPU self-sync speculation (chunked decode + resync) is broken by the
format's per-50-symbol table switching, which makes speculative decode
depend on the unknown global symbol index, not just the bit offset.
The concurrent host light parses overlap device execution (parse-ahead
thread); their share of the wall is not yet measured on the H100.
"""
from __future__ import annotations

import numpy as np

from . import constants as C
from . import native

#: blocks per device batch (tuned on an earlier accelerator; not yet
#: measured on the H100)
BATCH = 8
#: wave-1 walkers per block in the inverse-BWT splitter walk (4096 —
#: quarters the round-4 wave-1 step count at -9; the long-tail wave-2
#: segments shrink linearly with the wave-1 splitter spacing too)
WALKERS = 4096


def _g_buckets(level: int) -> tuple:
    """Group-count bucket(s) for the decode programs.  The format allows
    up to min(18002, 2000*level+2) groups per block while real text at -9
    uses ~10k; one full-size program per (level, wt) keeps the executable
    count at one per level (a text-sized second bucket is not yet
    measured on the H100)."""
    return (min(C.MAX_SELECTORS, 2000 * level + 2),)


def _jit_fns(level: int, wt_words: int, G: int):
    import jax
    import jax.numpy as jnp

    from .ops import decode as D

    N = 100_000 * level
    NOUT = N + N // 4 + 64

    # Four stage jits chained with explicit syncs, so STAGE_WALL times
    # each stage; whether one fused program or async chaining is faster
    # on the H100 is not yet measured.
    def grp_symbols(words, goff, gsel, gvalid, lens6, alpha):
        lut1, lut2, ebase = D.build_tables(lens6, alpha)
        return D.decode_symbols(words, goff, gsel, gvalid, lut1, lut2,
                                ebase)

    def grp_mtf(syms, used_list, n_used, n_mtf):
        vals = D.mtf_inverse(syms, used_list, n_used, n_mtf)
        return D.rle2_expand(syms, vals, n_used, n_mtf, N)

    def grp_tail(out, n_out, ok):
        raw, out_len, fits = D.rle1_inverse(out, n_out, NOUT)
        # no device CRC here: the raw bytes are fetched to the host anyway,
        # where the slice-by-8 C++ CRC checks them (ops/decode.crc32_device
        # stays as the library op for output that never visits a host)
        return raw.astype(jnp.uint8), out_len, ok & fits

    f_a = jax.jit(grp_symbols)
    f_m = jax.jit(grp_mtf)
    f_b = jax.jit(lambda l, n, o: D.ibwt(l, n, o, WALKERS))
    f_c = jax.jit(grp_tail)

    def pipeline(words, goff, gsel, gvalid, lens6, alpha,
                 used_list, n_used, n_mtf, orig):
        import time
        b = jax.block_until_ready
        t0 = time.time()
        syms = b(f_a(words, goff, gsel, gvalid, lens6, alpha))
        t1 = time.time()
        last, n_out = b(f_m(syms, used_list, n_used, n_mtf))
        t2 = time.time()
        out, ok = b(f_b(last, n_out, orig))
        t3 = time.time()
        raw8, out_len, okf = b(f_c(out, n_out, ok))
        t4 = time.time()
        for k, v in (("symbols", t1 - t0), ("mtf+rle2", t2 - t1),
                     ("ibwt", t3 - t2), ("tail", t4 - t3)):
            _stage_add(k, v)
        # the d2h fetch happens in _drain_batch, which the stream loop
        # runs on a side thread overlapped with the NEXT batch's stages
        return raw8, out_len, okf

    return pipeline, N, NOUT, G


#: cumulative per-stage device wall (seconds); tracing verbosity >= 3 and
#: bench read this out
STAGE_WALL: dict = {}
#: anomaly counters: every host heal is counted, not just logged to
#: stderr; bench prints these in its tail and the realism test asserts
#: they stay zero on well-formed -9 input
ANOMALIES: dict = {"lane": 0, "batch": 0}
_STAGE_LOCK = __import__("threading").Lock()


def _anomaly_add(kind: str) -> None:
    with _STAGE_LOCK:
        ANOMALIES[kind] = ANOMALIES.get(kind, 0) + 1


def _stage_add(key: str, wall: float) -> None:
    """Accumulate under a lock: concurrent pipeline calls from multiple
    engine worker threads would otherwise lose increments."""
    with _STAGE_LOCK:
        STAGE_WALL[key] = STAGE_WALL.get(key, 0.0) + wall


class DeviceDecoder:
    """Batched device block decoder (one compiled pipeline per
    (level, words-bucket))."""

    #: word-count buckets for the shared flat bit buffer
    WT_BUCKETS = (1 << 19, 1 << 21, 1 << 23)

    def __init__(self, batch_size: int = BATCH):
        from .compile_cache import enable_compile_cache
        enable_compile_cache()
        self.batch = batch_size
        self._fns = {}

    def _fn(self, level: int, wt: int, gb: int):
        key = (level, wt, gb)
        if key not in self._fns:
            self._fns[key] = _jit_fns(level, wt, gb)
        return self._fns[key]

    # ------------------------------------------------------------------
    def _decode_batch(self, stream: np.ndarray, level: int, pbs: list):
        """Decode a list of ParsedBlock on device; returns list of bytes
        or None (lane needs host fallback)."""
        import jax.numpy as jnp

        from .ops import decode as D

        B = self.batch
        # shared flat word buffer: one contiguous byte span covering all
        # blocks in the batch (they are adjacent in the stream)
        bit0 = min(pb.sym_start_bit for pb in pbs)
        bit1 = max(pb.end_bit for pb in pbs)
        wbase = bit0 // 32
        wend = (bit1 + 31) // 32 + 1
        need = wend - wbase
        wt = next((b for b in self.WT_BUCKETS if b >= need), None)
        if wt is None:
            return None
        gmax = max(pb.n_groups_used for pb in pbs)
        gb = next((b for b in _g_buckets(level) if b >= gmax), None)
        if gb is None:   # over-declared selector count: host fallback
            return None
        fn, N, NOUT, G = self._fn(level, wt, gb)

        span = stream[wbase * 4: min(wend * 4, stream.size)]
        wbytes = np.zeros(wt * 4, np.uint8)
        wbytes[: span.size] = span
        words_np = wbytes.view(">u4").astype(np.uint32)

        goff = np.zeros((B, G), np.int32)
        gsel = np.zeros((B, G), np.int32)
        gvalid = np.zeros((B, G), bool)
        lens6 = np.zeros((B, 6, 258), np.int32)
        alpha = np.full(B, 2, np.int32)
        used_list = np.zeros((B, 256), np.int32)
        n_used = np.ones(B, np.int32)
        n_mtf = np.ones(B, np.int32)
        orig = np.zeros(B, np.int32)

        for i, pb in enumerate(pbs):
            g = pb.n_groups_used
            if g > G:
                return None
            goff[i, :g] = pb.group_offsets - wbase * 32
            gsel[i, :g] = pb.selectors[:g]
            gvalid[i, :g] = True
            lens6[i] = pb.lens
            alpha[i] = pb.n_used + 2
            ul = np.flatnonzero(pb.used)
            used_list[i, : ul.size] = ul
            n_used[i] = pb.n_used
            n_mtf[i] = pb.n_mtf
            orig[i] = pb.orig_ptr

        # the pipeline call blocks per stage (see _jit_fns); the NEXT
        # batch's native parse still overlaps via the parse-ahead thread
        res = fn(
            jnp.asarray(words_np), jnp.asarray(goff), jnp.asarray(gsel),
            jnp.asarray(gvalid), jnp.asarray(lens6), jnp.asarray(alpha),
            jnp.asarray(used_list), jnp.asarray(n_used),
            jnp.asarray(n_mtf), jnp.asarray(orig))
        return res

    @staticmethod
    def _drain_batch(res, pbs):
        raw_dev, out_len, ok = res
        raw = np.asarray(raw_dev)   # d2h, overlapped with the next batch
        out_len = np.asarray(out_len)
        ok = np.asarray(ok)
        outs = []
        for i, pb in enumerate(pbs):
            if not bool(ok[i]):
                outs.append(None)
                continue
            b = raw[i, : int(out_len[i])].tobytes()
            # block CRC on the host (slice-by-8 C++): the bytes are already
            # fetched, and this is ~40x cheaper than a device GF(2) fold
            if native.crc32(b) != pb.stored_crc:
                outs.append(None)
            else:
                outs.append(b)
        return outs

    # ------------------------------------------------------------------
    def decompress(self, data, multi_stream: bool = True) -> bytes:
        return self.decompress_with_tail(data, multi_stream)[0]

    def decompress_with_tail(self, data, multi_stream: bool = True):
        """One-shot decode on the device path.  Batches with any lane
        anomaly are healed individually on the host (``decode_some`` over
        just that batch's bit span) and device decode continues; a stream
        whose framing the device path does not take (bad header, missing
        EOS) goes to the host decoder whole.  Returns (bytes,
        consumed_byte_offset)."""
        from .api import DataError, DataErrorMagic, UnexpectedEOF

        buf = np.frombuffer(bytes(data), np.uint8)
        out, consumed = self._decompress_stream(buf, multi_stream)
        if out is None:
            res, consumed, rc = native.decompress(
                bytes(data), multi_stream=multi_stream)
            if res is None:
                if rc == native.BZT_DATA_ERROR_MAGIC:
                    raise DataErrorMagic("bad stream header")
                if rc == native.BZT_UNEXPECTED_EOF:
                    raise UnexpectedEOF("stream truncated")
                raise DataError(f"corrupt stream (rc={rc})")
            return res, consumed
        return out, consumed

    def _decompress_stream(self, buf: np.ndarray, multi_stream: bool = True):
        """Returns (bytes, consumed_bytes) or (None, 0) => host fallback."""
        from .api import DataError, UnexpectedEOF

        parts = []
        pos_bit = 0
        total = buf.size * 8

        # --- speculative parse pool (see module docstring) -------------
        # submitted: candidate bit offset -> (level, future).  Entries are
        # keyed out when a later member's level differs; candidates behind
        # the stitch point (consumed or false) are swept on each pump.
        import concurrent.futures as _cf
        import os as _os

        scan_state = {"ex": None, "cands": None, "ci": 0}
        submitted = {}

        def _pump(pos, level):
            st = scan_state
            if st["cands"] is None:
                from .parallel.decode import find_bit_magics
                st["cands"] = find_bit_magics(buf, C.BLOCK_MAGIC)
                st["ex"] = _cf.ThreadPoolExecutor(
                    max_workers=min(8, (_os.cpu_count() or 1) + 1))
            cands = st["cands"]
            ci = st["ci"]
            while ci < len(cands) and cands[ci] < pos:
                submitted.pop(int(cands[ci]), None)
                ci += 1
            st["ci"] = ci
            j = ci
            while j < len(cands) and len(submitted) < 4 * self.batch:
                c = int(cands[j])
                j += 1
                ent = submitted.get(c)
                if ent is None or ent[0] != level:
                    # new candidate, or stale speculation from a previous
                    # member with a different level: (re)parse correctly
                    submitted[c] = (level, st["ex"].submit(
                        native.parse_block, buf, c, level))

        def _get_parse(pos, level):
            ent = submitted.pop(pos, None)
            if ent is not None and ent[0] == level:
                return ent[1].result()
            return native.parse_block(buf, pos, level)

        try:
            return self._stream_loop(buf, multi_stream, parts, pos_bit,
                                     total, _pump, _get_parse)
        finally:
            if scan_state["ex"] is not None:
                scan_state["ex"].shutdown(wait=False, cancel_futures=True)

    def _stream_loop(self, buf, multi_stream, parts, pos_bit, total,
                     _pump, _get_parse):
        from .api import DataError, UnexpectedEOF  # noqa: F811
        while True:
            # stream header
            if total - pos_bit < 32:
                return None, 0
            hdr = bytes(buf[pos_bit // 8: pos_bit // 8 + 4])
            if (pos_bit % 8 or hdr[:3] != b"BZh"
                    or not (0x31 <= hdr[3] <= 0x39)):
                return None, 0
            level = hdr[3] - 0x30
            pos_bit += 32
            combined = 0

            def heal_span(start_bit, end_bit, comb_in):
                """Host-decode exactly [start_bit, end_bit); returns
                (bytes, combined_out)."""
                sl = np.ascontiguousarray(buf[: (end_bit + 7) // 8])
                out, next_bit, _lvl, comb2, _st, rc = native.decode_some(
                    sl, start_bit, level, comb_in)
                if out is None or next_bit != end_bit:
                    raise DataError(f"corrupt stream (host heal rc={rc})")
                return out, comb2

            def commit(res, pbs, start_bit, end_bit):
                nonlocal combined
                import sys
                outs = (self._drain_batch(res, pbs)
                        if res is not None else None)
                if outs is None:  # whole-batch device failure
                    _anomaly_add("batch")
                    sys.stderr.write("bz2tpu: device batch anomaly; "
                                     "batch healed on host\n")
                    out, combined = heal_span(start_bit, end_bit, combined)
                    parts.append(out)
                    return
                for pb, o in zip(pbs, outs):
                    if o is None:
                        # one lane flagged (walker cap on a skewed cycle,
                        # CRC mismatch): heal just this block — the rest
                        # of the batch keeps its device results
                        _anomaly_add("lane")
                        sys.stderr.write("bz2tpu: device lane anomaly; "
                                         "block healed on host\n")
                        o, _ = heal_span(pb.start_bit, pb.end_bit, 0)
                    combined = (((combined << 1) | (combined >> 31))
                                & 0xFFFFFFFF) ^ pb.stored_crc
                    parts.append(o)

            magic = self._peek48(buf, pos_bit)
            if magic not in (C.EOS_MAGIC, C.BLOCK_MAGIC):
                return None, 0
            parse_fail = False
            if magic == C.BLOCK_MAGIC:
                # two-stage pipeline: the native parse of batch k+1 (a
                # GIL-releasing light scan) and the host prep overlap
                # batch k's device execution; device results are forced
                # only at drain time.
                import concurrent.futures as _cf

                def parse_batch(pos):
                    pbs = []
                    while len(pbs) < self.batch:
                        _pump(pos, level)  # keep candidate parses in flight
                        pb, rc = _get_parse(pos, level)
                        if pb is None:
                            return (pbs, pos, False) if pbs else None
                        if pb.randomised:
                            return None     # legacy path: host decoder
                        pb.start_bit = pos  # for single-block host healing
                        pbs.append(pb)
                        pos = pb.end_bit
                        if self._peek48(buf, pos) != C.BLOCK_MAGIC:
                            return pbs, pos, False
                    return pbs, pos, self._peek48(buf, pos) == C.BLOCK_MAGIC

                # three-way overlap: the parse-ahead thread scans batch
                # k+1's headers, the main thread drives batch k's device
                # stages, and the commit thread fetches + CRC-checks
                # batch k-1's output — d2h rides under device compute, so
                # STAGE_WALL can include transfer time.
                pending = None
                cfut = None
                with _cf.ThreadPoolExecutor(max_workers=1) as ex, \
                        _cf.ThreadPoolExecutor(max_workers=1) as cex:
                    fut = ex.submit(parse_batch, pos_bit)
                    while True:
                        parsed = fut.result()
                        if parsed is None:
                            parse_fail = True
                            break
                        pbs, newpos, more = parsed
                        if more:
                            fut = ex.submit(parse_batch, newpos)
                        if pending is not None:
                            cfut = cex.submit(commit, *pending)
                            pending = None
                        res = self._decode_batch(buf, level, pbs)
                        if cfut is not None:
                            cfut.result()
                            cfut = None
                        pending = (res, pbs, pos_bit, newpos)
                        pos_bit = newpos
                        if not more:
                            break
                    if cfut is not None:
                        cfut.result()
                if pending is not None:
                    commit(*pending)
            if parse_fail:
                # parse error, randomised legacy block, or truncation:
                # host-decode the member's remainder and resume
                out, next_bit, _lvl, comb2, status, rc = native.decode_some(
                    buf, pos_bit, level, combined)
                if out is None:
                    if rc == native.BZT_UNEXPECTED_EOF:
                        raise UnexpectedEOF("stream truncated")
                    raise DataError(f"corrupt stream (rc={rc})")
                if status != 1:
                    raise UnexpectedEOF("stream truncated")
                parts.append(out)
                pos_bit = next_bit
            else:
                if self._peek48(buf, pos_bit) != C.EOS_MAGIC:
                    return None, 0
                pos_bit += 48
                if total - pos_bit < 32:
                    return None, 0
                stored = 0
                for k in range(32):
                    byte_i = (pos_bit + k) // 8
                    bit = (int(buf[byte_i]) >> (7 - (pos_bit + k) % 8)) & 1
                    stored = (stored << 1) | bit
                pos_bit += 32
                if stored != combined:
                    raise DataError("combined CRC mismatch")
            # byte-align and look for another member
            pos_bit = (pos_bit + 7) // 8 * 8
            if multi_stream and pos_bit // 8 + 4 <= buf.size and \
                    bytes(buf[pos_bit // 8: pos_bit // 8 + 3]) == b"BZh":
                continue
            break
        return b"".join(parts), pos_bit // 8

    @staticmethod
    def _peek48(buf: np.ndarray, bit: int) -> int:
        if (bit + 48) > buf.size * 8:
            return -1
        v = 0
        for k in range(6):
            byte_i = (bit + 8 * k) // 8
            sh = bit % 8
            b0 = int(buf[byte_i]) << 8
            b1 = int(buf[byte_i + 1]) if byte_i + 1 < buf.size else 0
            v = (v << 8) | (((b0 | b1) >> (8 - sh)) & 0xFF)
        return v


_default: DeviceDecoder | None = None


def default_decoder() -> DeviceDecoder:
    global _default
    if _default is None:
        _default = DeviceDecoder()
    return _default
