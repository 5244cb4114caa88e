"""Device block-encode engine: one jitted function per (batch, block-size)
bucket that takes padded RLE1 blocks and returns fully serialized per-block
bitstreams, plus the host orchestration that batches blocks, invokes the
device, and bit-splices the results into a .bz2 stream.

Device pipeline (all one jit):
  BWT (multi-key sort prefix doubling)            ops.bwt
  MTF + RLE2 + frequencies                        ops.mtf
  6-table group search, 4 iterations              ops.groupsearch
  exact-heap Huffman lengths + canonical codes    ops.huffman
  field emission (headers, selectors, delta       here
    tables, payload) -> packed words              ops.bitpack

Host keeps: RLE1 + block splitting (bzip2_tpu.rle1), CRC32, stream
header/EOS framing, and the ordered bit-splice of per-block payloads
(reference semantics: bzlib.c / compress.c; the wire layout is documented in
oracle/block.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from . import crc as _crc
from .compile_cache import enable_compile_cache
from . import hostmem as _hostmem
from . import rle1 as _rle1
from . import tracing
from .bitstream import BitWriter, splice
from .ops.bitpack import pack_fields
from .ops.bwt import bwt_batched
from .ops.groupsearch import group_iter as group_iter_jit
from .ops.groupsearch import group_search_batched
from .ops.mtf import mtf_rle2_batched

A = C.MAX_ALPHA_SIZE

#: cumulative encode-side stage walls (seconds) and block-share counters
#: (what fraction of the stream the device actually encoded).  Reset via
#: reset_telemetry().
STAGE_WALL: dict = {}
SHARE: dict = {"dev_blocks": 0, "host_blocks": 0, "declines": 0}
_TELEM_LOCK = __import__("threading").Lock()


def _stage_add(key: str, wall: float) -> None:
    with _TELEM_LOCK:
        STAGE_WALL[key] = STAGE_WALL.get(key, 0.0) + wall


def _share_add(key: str, k: int = 1) -> None:
    with _TELEM_LOCK:
        SHARE[key] = SHARE.get(key, 0) + k


def reset_telemetry() -> None:
    with _TELEM_LOCK:
        STAGE_WALL.clear()
        SHARE.update({"dev_blocks": 0, "host_blocks": 0, "declines": 0})


def _emit_fields(blocks, n, in_use, crc, orig_ptr, mtfv, n_mtf, n_in_use,
                 n_groups, n_selectors, sel_mtf, lens, codes, selectors):
    """Build the (vals, lens) field arrays for one batch.  Shapes static."""
    B, M = mtfv.shape
    G = sel_mtf.shape[1]
    u32 = jnp.uint32
    i32 = jnp.int32

    fields_v = []
    fields_l = []

    def add(v, l):
        fields_v.append(v.astype(u32))
        fields_l.append(l.astype(i32))

    ones = jnp.ones((B,), i32)
    # block magic + CRC + (rand bit | origPtr)
    add(jnp.full((B,), C.BLOCK_MAGIC >> 24, u32)[:, None], (ones * 24)[:, None])
    add(jnp.full((B,), C.BLOCK_MAGIC & 0xFFFFFF, u32)[:, None], (ones * 24)[:, None])
    add(crc.astype(u32)[:, None], (ones * 32)[:, None])
    add(orig_ptr.astype(u32)[:, None], (ones * 25)[:, None])  # rand=0 ++ origPtr

    # mapping: 16-bit group mask, then 16 bits per used group
    iu = in_use.reshape(B, 16, 16)
    gmask_bits = jnp.any(iu, axis=2)                                  # (B,16)
    w16 = (1 << jnp.arange(15, -1, -1, dtype=i32))[None, :]
    gmask = jnp.sum(jnp.where(gmask_bits, w16, 0), axis=1)
    add(gmask[:, None], (ones * 16)[:, None])
    gbits = jnp.sum(jnp.where(iu, w16[None], 0), axis=2)              # (B,16)
    add(gbits, jnp.where(gmask_bits, 16, 0))

    add(n_groups.astype(u32)[:, None], (ones * 3)[:, None])
    add(n_selectors.astype(u32)[:, None], (ones * 15)[:, None])

    # selectors: value v in 1..6 -> v bits of pattern (1<<v)-2
    add((jnp.uint32(1) << sel_mtf.astype(u32)) - 2, jnp.where(sel_mtf > 0, sel_mtf, 0))

    # coding tables: per table, 5-bit first length then per-symbol
    # {"10"*d | "11"*d, then "0"}.
    arange_a = jnp.arange(A, dtype=i32)[None, None, :]
    alpha = n_in_use + 2
    t_active = (jnp.arange(6, dtype=i32)[None, :] < n_groups[:, None])  # (B,6)
    sym_active = arange_a < alpha[:, None, None]                        # (B,1,A)
    active = jnp.logical_and(t_active[:, :, None], sym_active)          # (B,6,A)
    lens_m = jnp.where(active, lens, 0)
    first = lens_m[:, :, 0]
    prev = jnp.concatenate([first[:, :, None], lens_m[:, :, :-1]], axis=2)
    delta = jnp.where(active, lens_m - prev, 0)
    up = jnp.maximum(delta, 0)
    down = jnp.maximum(-delta, 0)
    nbits_d = 2 * (up + down)
    pat_up = jnp.where(delta > 0,
                       jnp.uint32(0xAAAAAAAA) >> jnp.clip(32 - 2 * up, 0, 31).astype(u32), 0)
    pat_dn = jnp.where(delta < 0,
                       jnp.uint32(0xFFFFFFFF) >> jnp.clip(32 - 2 * down, 0, 31).astype(u32), 0)
    # Wire order interleaves per table: [5-bit first][delta,stop]*A, table by
    # table — build (B, 6, 1+2A) slot planes and flatten row-major.
    tab_v = jnp.zeros((B, 6, 1 + 2 * A), u32)
    tab_l = jnp.zeros((B, 6, 1 + 2 * A), i32)
    tab_v = tab_v.at[:, :, 0].set(first.astype(u32))
    tab_l = tab_l.at[:, :, 0].set(jnp.where(t_active, 5, 0))
    tab_v = tab_v.at[:, :, 1::2].set((pat_up + pat_dn).astype(u32))
    tab_l = tab_l.at[:, :, 1::2].set(nbits_d)
    tab_l = tab_l.at[:, :, 2::2].set(jnp.where(active, 1, 0))
    add(tab_v.reshape(B, 6 * (1 + 2 * A)), tab_l.reshape(B, 6 * (1 + 2 * A)))

    # payload: per-symbol code from its group's table, formulated without
    # an element-wise gather (chosen from an earlier accelerator's costs,
    # not yet re-measured on the H100): select each group's table row with
    # a 6-way masked sum, then resolve the per-symbol entry with a one-hot
    # batched matmul over the alphabet.  Operands are bf16 with f32
    # accumulation, and every value is an integer below 2^24 (byte planes
    # <= 255, one nonzero term per sum), so the products are exact and
    # TF32 never applies.  (code, len) pack into one word (codes <= 17
    # bits, lens <= 5 bits) so one matmul pass covers both.
    Gn = selectors.shape[1]
    m_valid = jnp.arange(M, dtype=i32)[None, :] < n_mtf[:, None]
    packed_tab = (codes.astype(i32) << 5) | lens                  # (B,6,A)
    sel_hot = (selectors[:, :, None]
               == jnp.arange(6, dtype=i32)[None, None, :])        # (B,G,6)
    # per-group table rows as 3 bf16 byte planes: (B, G, A, 3)
    tab_rows = jax.lax.dot_general(
        sel_hot.astype(jnp.bfloat16),
        jnp.stack([(packed_tab & 0xFF), (packed_tab >> 8) & 0xFF,
                   packed_tab >> 16], axis=-1).astype(jnp.bfloat16),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    # chunk the (B, G, G_SIZE, A) one-hot over G to bound the transient
    n_chunks = 4 if Gn >= 64 else 1
    Gp = -(-Gn // n_chunks) * n_chunks
    Gc = Gp // n_chunks
    mtf_g = jnp.pad(mtfv, ((0, 0), (0, Gp * C.G_SIZE - M))
                    ).reshape(B, Gp, C.G_SIZE)
    tab_p = jnp.pad(tab_rows, ((0, 0), (0, Gp - Gn), (0, 0), (0, 0)))

    def chunk_pay(c):
        oh = (mtf_g[:, c * Gc:(c + 1) * Gc, :, None]
              == arange_a[:, None, 0, :]).astype(jnp.bfloat16)
        return jax.lax.dot_general(
            oh, tab_p[:, c * Gc:(c + 1) * Gc],
            dimension_numbers=(((3,), (2,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.float32)
    pay3 = jnp.concatenate([chunk_pay(c) for c in range(n_chunks)], axis=1)
    pay3 = pay3.astype(i32)                               # (B,Gp,G_SIZE,3)
    pay = (pay3[..., 0] | (pay3[..., 1] << 8)
           | (pay3[..., 2] << 16)).reshape(B, Gp * C.G_SIZE)[:, :M]
    add(jnp.where(m_valid, (pay >> 5).astype(u32), 0),
        jnp.where(m_valid, pay & 31, 0))

    vals = jnp.concatenate(fields_v, axis=1)
    flens = jnp.concatenate(fields_l, axis=1)
    return vals, flens


def encode_batch_device(blocks, n, in_use, crc, n_words: int):
    """The full jitted encoder: (B,N) uint8 padded RLE1 blocks -> packed
    per-block bitstreams (B, n_words) uint32 + bit counts (B,)."""
    last, orig_ptr, _ = bwt_batched(blocks, n)
    mtfv, n_mtf, n_in_use = mtf_rle2_batched(last, n, in_use)
    n_groups, n_selectors, selectors, sel_mtf, lens, codes = group_search_batched(
        mtfv, n_mtf, n_in_use)
    vals, flens = _emit_fields(blocks, n, in_use, crc, orig_ptr, mtfv, n_mtf,
                               n_in_use, n_groups, n_selectors, sel_mtf, lens,
                               codes, selectors)
    return pack_fields(vals, flens, n_words)


# --- hybrid path: device stages with the exact-heap Huffman on the host ---
# (C++ runtime; tiny serial heaps are the one stage a wide device is wrong
# for).

MTF_TILE = 2048


def encode_pre(blocks, n, in_use):
    from .ops.groupsearch import (build_group_hist, initial_tables_batched,
                                  n_groups_batched)

    last, orig_ptr, _ = bwt_batched(blocks, n)
    mtfv, n_mtf, n_in_use = mtf_rle2_batched(last, n, in_use, tile=MTF_TILE)
    n_groups = n_groups_batched(n_mtf)
    hist = build_group_hist(mtfv, n_mtf)
    freq = jnp.sum(hist, axis=1)
    lens0 = initial_tables_batched(freq, n_mtf, n_in_use + 2, n_groups)
    hist_bf = hist.astype(jnp.bfloat16)
    table_invalid = (jnp.arange(6, dtype=jnp.int32)[None, :]
                     >= n_groups[:, None])
    return (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens0, hist_bf,
            table_invalid)


def encode_post(mtfv, n_mtf, n_in_use, in_use, crc, orig_ptr, n_groups,
                selectors, lens, n_words: int):
    from .ops.groupsearch import selector_mtf
    from .ops.huffman import assign_codes_lanes

    B = mtfv.shape[0]
    alpha = n_in_use + 2
    codes = assign_codes_lanes(
        lens.reshape(B * 6, A),
        jnp.broadcast_to(alpha[:, None], (B, 6)).reshape(B * 6)).reshape(B, 6, A)
    n_selectors = -(-n_mtf // C.G_SIZE)
    sel_mtf = selector_mtf(selectors, n_selectors)
    vals, flens = _emit_fields(None, None, in_use, crc, orig_ptr, mtfv, n_mtf,
                               n_in_use, n_groups, n_selectors, sel_mtf, lens,
                               codes, selectors)
    return pack_fields(vals, flens, n_words)


def _block_pad_size(level: int) -> int:
    n = C.nblock_max(level) + C.BLOCK_OVERSHOOT
    return -(-n // MTF_TILE) * MTF_TILE


def _words_for(N: int) -> int:
    # worst case: 17-bit codes for every symbol + headers, with slack
    return (17 * (N + 1) + 6 * A * 3 + C.MAX_SELECTORS * 6 + 4096) // 32 + 4


def lax_slice_words(words, k: int):
    return words[:, :k]


class Engine:
    """Batched device encoder with per-(level, batch) compile caching.

    mode "hybrid" (default when the native runtime is built): device runs
    BWT/MTF/group-search matmuls/bit packing; the 4 Huffman rebuilds per
    batch run in C++ on the host (25 KB/iter transfers).  mode "fused": the
    whole encoder in a single jit (used by the graft entry / sharding
    dryrun; also the fallback without a compiler).
    """

    #: target bytes of input per device batch when batch_size is automatic
    #: (12 MB = 13 blocks at -9, so the per-batch fixed costs — the 4 heap
    #: round-trips and the dispatch/fetch latencies — amortize).  Tuned on
    #: an earlier accelerator; not yet measured on the H100.
    AUTO_BATCH_BYTES = 12 << 20

    def __init__(self, batch_size: int | None = None, mode: str | None = None,
                 pipeline: int = 2, host_workers: int | None = None,
                 use_device: bool = True):
        # allocator retention is an Engine-scoped policy, not an import-time
        # side effect (embedding applications keep their default glibc
        # behavior until they actually construct an engine).
        _hostmem.set_malloc_retention()
        enable_compile_cache()
        self.batch_size = batch_size
        self.pipeline = max(1, pipeline)
        #: False = host-only scheduling (native C++ workers; the device is
        #: never touched).
        self.use_device = use_device
        native_ok = False
        try:
            from . import native
            native_ok = native.available()
        except Exception:
            pass
        if mode is None:
            mode = "hybrid" if native_ok else "fused"
        self.mode = mode
        # host workers co-encode blocks on the CPU (native C++ encoder)
        # while the device crunches batches — work-stealing from the tail.
        if host_workers is None:
            host_workers = 1 if native_ok else 0
        self.host_workers = host_workers if native_ok else 0
        self._compiled = {}
        self._slicers = {}
        self._prepared: set[int] = set()
        #: work-stealing scheduler telemetry (persists across streams so a
        #: fresh stream starts with calibrated rates)
        self._sched = {"host_done": 0, "host_time": 0.0, "dev_wall": 0.0}

    def _batch_size_for(self, level: int) -> int:
        if self.batch_size is not None:
            return self.batch_size
        return max(1, self.AUTO_BATCH_BYTES // (C.BLOCK_UNIT * level))

    def _slice_words(self, words_dev, nbits_np):
        """Fetch only the used prefix of the words buffer (bucketed static
        slice sizes keep recompiles bounded)."""
        need = int((int(nbits_np.max()) + 31) // 32)
        bucket = 1 << max(10, need - 1).bit_length()
        bucket = min(bucket, words_dev.shape[1])
        key = (words_dev.shape, bucket)
        if key not in self._slicers:
            self._slicers[key] = jax.jit(
                functools.partial(lax_slice_words, k=bucket))
        return np.asarray(self._slicers[key](words_dev))

    def _fns(self, level: int, bsz: int):
        key = (level, bsz, self.mode)
        if key not in self._compiled:
            N = _block_pad_size(level)
            W = _words_for(N)
            if self.mode == "fused":
                self._compiled[key] = jax.jit(
                    functools.partial(encode_batch_device, n_words=W))
            else:
                # every batch runs in the one primary-size executable (tails
                # are padded with dummy lanes): one executable set keeps
                # cold-start to a single compile.
                self._compiled[key] = (
                    jax.jit(encode_pre),
                    jax.jit(group_iter_jit),
                    jax.jit(functools.partial(encode_post, n_words=W)),
                )
        return self._compiled[key]

    def prepare(self, level: int, bsz: int | None = None) -> None:
        """Warm-compile the batch executables for ``level`` (batch size
        ``bsz``, default the primary size) with the three stage compiles
        issued from parallel threads, overlapped with any host workers.
        No-op once compiled."""
        if self.mode == "fused" or not self.use_device:
            return
        if bsz is None:
            bsz = self._batch_size_for(level)
        if (level, bsz) in self._prepared:
            return
        import threading
        N = _block_pad_size(level)
        f_pre, f_iter, f_post = self._fns(level, bsz)

        # dummy args as NUMPY arrays, converted exactly the way real
        # batches are (run_batch: jnp.asarray of C-order numpy) so the
        # warmed dispatch-cache entries are the ones real calls hit
        arr = np.zeros((bsz, N), np.uint8)
        ns = np.ones((bsz,), np.int32)
        uses_np = np.zeros((bsz, 256), bool)
        uses_np[:, 0] = True
        pre_args = (jnp.asarray(arr), jnp.asarray(ns), jnp.asarray(uses_np))
        uses = pre_args[2]
        # derive the exact inter-stage shapes without compiling
        (mtfv_s, n_mtf_s, n_in_use_s, orig_s, n_groups_s, lens0_s, hist_s,
         inval_s) = jax.eval_shape(f_pre, *pre_args)

        def z(s, fill=0):
            return jnp.full(s.shape, fill, s.dtype)

        hist, lens, inval = z(hist_s), z(lens0_s, 15), z(inval_s)
        sel_s, _freq_s = jax.eval_shape(f_iter, hist, lens, inval)
        post_args = (z(mtfv_s), z(n_mtf_s, 1), z(n_in_use_s, 1), uses,
                     jnp.zeros((bsz,), jnp.uint32), z(orig_s),
                     z(n_groups_s, 2), z(sel_s), lens)

        # Lower sequentially, compile in parallel; sequential dummy
        # executions then bind the executables into the jit dispatch
        # caches (via the persistent compilation cache).
        plan = [(f_pre, pre_args), (f_iter, (hist, lens, inval)),
                (f_post, post_args)]
        lowered = [f.lower(*args) for f, args in plan]
        threads = [threading.Thread(target=lo.compile) for lo in lowered]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f, args in plan:
            jax.block_until_ready(f(*args))
        self._prepared.add((level, bsz))

    def _encode_batch(self, level, arr, ns, uses, crcs):
        """Run one device batch; returns (words_np, nbits_np) with words
        fetched through a bucketed device-side slice."""
        import time as _time
        fns = self._fns(level, arr.shape[0])
        if self.mode == "fused":
            words, nbits = fns(jnp.asarray(arr), jnp.asarray(ns),
                               jnp.asarray(uses), jnp.asarray(crcs))
        else:
            from . import native
            f_pre, f_iter, f_post = fns
            t0 = _time.time()
            (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens, hist_bf,
             table_invalid) = f_pre(jnp.asarray(arr), jnp.asarray(ns),
                                    jnp.asarray(uses))
            B = arr.shape[0]
            # np.asarray forces f_pre (async dispatch) before the wall read
            alpha6 = np.repeat(np.asarray(n_in_use) + 2, 6).astype(np.int32)
            t1 = _time.time()
            selectors = None
            for _ in range(C.N_ITERS):
                selectors, freq6 = f_iter(hist_bf, lens, table_invalid)
                freq_np = np.asarray(freq6).reshape(B * 6, A)
                lens_np = native.make_code_lengths_batch(freq_np, alpha6)
                lens = jnp.asarray(lens_np.reshape(B, 6, A))
            t2 = _time.time()
            words, nbits = f_post(mtfv, n_mtf, n_in_use, jnp.asarray(uses),
                                  jnp.asarray(crcs), orig_ptr, n_groups,
                                  selectors, lens)
            _stage_add("pre(bwt+mtf+hist)", t1 - t0)
            _stage_add("4xiter+heap", t2 - t1)
        t3 = _time.time()
        nbits_np = np.asarray(nbits)
        out = self._slice_words(words, nbits_np), nbits_np
        if self.mode != "fused":
            _stage_add("post+fetch", _time.time() - t3)
        return out

    def encode_payloads(self, blocks: list[_rle1.RLE1Block], level: int):
        """Encode RLE1 blocks into per-block (bytes, nbits) payloads.

        Work-stealing hybrid scheduler: ``pipeline`` device workers claim
        batches from the front of the block list while ``host_workers``
        CPU workers (native C++ encoder, GIL released) steal single blocks
        from the tail — both compute resources run concurrently and meet in
        the middle.  Results are emitted in block order.
        """
        import threading

        L = len(blocks)
        if L == 0:
            return []
        N = _block_pad_size(level)
        # exactly two executable sizes per level: tiny streams (<= 2
        # blocks) use a 2-lane bucket so a one-block compress never pays a
        # full-batch compile; everything else pads into the one primary
        # executable (the tail batch's dummy lanes cost at most one batch
        # wall, and the adaptive handoff usually gives tails to the host).
        primary = self._batch_size_for(level)
        bsz = 2 if (L <= 2 and primary > 2) else primary

        results: list = [None] * L
        lock = threading.Lock()
        state = {"lo": 0, "hi": L, "dev_inflight": 0}
        sched = self._sched  # measured rates, persisted across calls

        def claim_front():
            """Device batch claim.  Adaptive tail handoff: once both rates
            are known, the device declines a batch whenever the host pool
            alone would finish the remainder sooner than the device's
            backlog (in-flight batches serialize on the one chip) plus this
            batch — otherwise a late-started device batch gates the whole
            stream while the host sits idle."""
            with lock:
                remaining = state["hi"] - state["lo"]
                if (remaining > 0 and host_threads and sched["dev_wall"]
                        and sched["host_done"] >= 3):
                    host_rate = (sched["host_done"] / sched["host_time"]
                                 * len(host_threads))
                    backlog = (state["dev_inflight"] + 1) * sched["dev_wall"]
                    if remaining <= host_rate * backlog * 0.9:
                        # Starvation guard: a dev_wall poisoned high by a
                        # one-off stall (cold compile, cache load) would
                        # otherwise make the device decline forever — the
                        # min-biased estimate can only correct if batches
                        # actually run.  Probe with one batch when the
                        # device is idle and the stream is long enough
                        # that a slow probe cannot gate it.
                        sched["declines"] = sched.get("declines", 0) + 1
                        _share_add("declines")
                        if not (state["dev_inflight"] == 0
                                and remaining > 5 * bsz
                                and sched["declines"] >= 8):
                            return 0, 0
                        sched["declines"] = 0
                take = min(bsz, remaining)
                s = state["lo"]
                state["lo"] += take
                if take:
                    state["dev_inflight"] += 1
                return s, take

        def claim_back():
            with lock:
                if state["hi"] <= state["lo"]:
                    return -1
                state["hi"] -= 1
                return state["hi"]

        def record_block(k, nbit):
            blk = blocks[k]
            tracing.vlog(2, "    block %d: crc 0x%08x, in %d, out %d bits"
                         " (%.3f bits/byte)", k, blk.crc,
                         blk.raw_span[1] - blk.raw_span[0], nbit,
                         nbit / max(blk.raw_span[1] - blk.raw_span[0], 1))
            tracing.record("block", index=k, crc=blk.crc,
                           raw_bytes=blk.raw_span[1] - blk.raw_span[0],
                           rle1_bytes=int(blk.data.size), out_bits=nbit)

        def run_batch(s, take):
            chunk = blocks[s:s + take]
            # tail batches are padded with dummy lanes into the one
            # primary-size executable: a cold start pays exactly one
            # (pre, iter, post) compile set, and the host workers usually
            # steal the tail before the device reaches it anyway
            pad_to = bsz
            arr = np.zeros((pad_to, N), np.uint8)
            ns = np.ones(pad_to, np.int32)
            uses = np.zeros((pad_to, 256), bool)
            crcs = np.zeros(pad_to, np.uint32)
            uses[:, 0] = True  # dummy lanes: 1-byte block of 0x00
            for j, blk in enumerate(chunk):
                arr[j, :blk.data.size] = blk.data
                ns[j] = blk.data.size
                uses[j] = blk.in_use
                crcs[j] = blk.crc
            import time as _time
            t0 = _time.time()
            with tracing.span(f"batch[{s}:{s + take}]"):
                words, nbits = self._encode_batch(level, arr, ns, uses, crcs)
            wall = _time.time() - t0
            with lock:
                # min-biased estimate of the device batch wall: queued or
                # cold batches report inflated walls (first compile-cache
                # load), and a poisoned-high estimate starves
                # the device permanently; a fast batch resets the belief
                # immediately while slow ones only drag it up gently.
                if not sched["dev_wall"] or wall < sched["dev_wall"]:
                    sched["dev_wall"] = wall
                else:
                    sched["dev_wall"] = (0.8 * sched["dev_wall"]
                                         + 0.2 * wall)
                state["dev_inflight"] -= 1
            _share_add("dev_blocks", take)
            for j in range(take):
                nbit = int(nbits[j])
                payload = words[j, : (nbit + 31) // 32]
                by = payload.byteswap().view(np.uint8)  # MSB-first bytes
                results[s + j] = (by[: (nbit + 7) // 8], nbit)
                record_block(s + j, nbit)

        errors: list = []

        def device_worker():
            try:
                while not errors:
                    s, take = claim_front()
                    if take == 0:
                        return
                    run_batch(s, take)
            except BaseException as e:  # noqa: BLE001 — re-raised after join
                errors.append(e)

        def host_worker():
            import time as _time

            from . import native
            try:
                while not errors:
                    k = claim_back()
                    if k < 0:
                        return
                    blk = blocks[k]
                    t0 = _time.time()
                    payload, nbits = native.encode_block(blk.data,
                                                         blk.in_use, blk.crc)
                    dt = _time.time() - t0
                    with lock:
                        sched["host_done"] += 1
                        sched["host_time"] += dt
                    _share_add("host_blocks")
                    results[k] = (np.frombuffer(payload, np.uint8), nbits)
                    record_block(k, nbits)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        host_threads = []
        n_host = self.host_workers
        if not self.use_device:
            n_host = max(1, n_host)
        if n_host:
            try:
                from . import native
                if native.available():
                    host_threads = [threading.Thread(target=host_worker)
                                    for _ in range(n_host)]
                    for t in host_threads:
                        t.start()
            except Exception:
                host_threads = []
        if not self.use_device:
            if not host_threads:
                raise RuntimeError("use_device=False requires the native "
                                   "encoder")
            host_worker()   # main thread joins the host pool

        # warm the compile caches (stage compiles issued in parallel and
        # overlapped with the already-running host workers), then fan out
        if self.use_device:
            try:
                self.prepare(level, bsz)
            except BaseException as e:  # noqa: BLE001 — re-raised after join
                errors.append(e)
        if self.use_device and not errors:
            dev_threads = [threading.Thread(target=device_worker)
                           for _ in range(max(0, self.pipeline - 1))]
            for t in dev_threads:
                t.start()
            device_worker()
            for t in dev_threads:
                t.join()
        for t in host_threads:
            t.join()
        if errors:
            raise errors[0]
        assert all(r is not None for r in results)
        return results

    def compress(self, data, level: int = 9) -> bytes:
        blocks = _rle1.encode_blocks(data, level)
        payloads = self.encode_payloads(blocks, level) if blocks else []
        return assemble_stream(payloads, blocks, level)


def assemble_stream(payloads, blocks: list[_rle1.RLE1Block],
                    level: int) -> bytes:
    """One .bz2 stream from per-block (bytes, nbits) payloads in block
    order: stream header, the payloads (after the periodic-block
    correction), end-of-stream magic and combined CRC."""
    from . import periodic
    if blocks:
        payloads = periodic.patch_payloads(payloads, blocks, level)
    w = BitWriter()
    for v in (C.HDR_B, C.HDR_Z, C.HDR_h, C.HDR_0 + level):
        w.write(v, 8)
    parts = [w.getvalue()]
    parts.extend(payloads)
    eos = BitWriter()
    eos.write(C.EOS_MAGIC, 48)
    eos.write(_crc.combine_block_crcs([b.crc for b in blocks]), 32)
    parts.append(eos.getvalue())
    return splice(parts)[0].tobytes()


_default_engine: Engine | None = None


def default_engine() -> Engine:
    global _default_engine
    if _default_engine is None:
        _default_engine = Engine()
    return _default_engine


def register_backend() -> None:
    """Register the device engine as block-encoder backend "tpu" for
    api.compress(..., backend="tpu")."""
    from . import api

    api.register_block_encoder(
        "tpu", lambda blocks, level: default_engine().encode_payloads(blocks, level))
