"""Block-data-parallel encoding over a jax.sharding.Mesh.

The block axis is sharded across the mesh ("blocks" axis): the arrays
carry NamedSharding annotations and ONE jitted program covers the whole
mesh — XLA's SPMD partitioner splits every batched op along the block
axis and inserts the single collective the contract needs (the all-gather
of per-block bit lengths, whose output sharding is declared replicated;
SURVEY §2.3).  Compressed payload words stay device-sharded until the
host gathers them in block order for the bit splice.

Why annotations and not ``shard_map``: every op is batched along the
sharded axis and partitions trivially, so the annotated program is the
plain-jit program per device.  (On an earlier accelerator the
shard_map-wrapped encoder compiled far slower schedules; not yet compared
on the H100.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine import encode_batch_device

#: jitted word-prefix slicers keyed by (shape, bucket) — see
#: encode_blocks_sharded
_SLICERS: dict = {}

#: count of sharded-decode lanes healed on the host (walker-cap / CRC
#: anomalies) — observability mirror of decoder.ANOMALIES for the mesh
#: path; tests assert the heal path actually fires when squeezed
HEALS = {"lane": 0}


def make_mesh(devices=None, axis: str = "blocks") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


_BUILT: dict = {}   # (kind, mesh, shape key) -> jitted program


def build_sharded_encoder(mesh: Mesh, n_words: int, axis: str = "blocks"):
    """Returns a jitted SPMD encoder over the mesh.

    fn(blocks (B, N) u8, n (B,), in_use (B,256), crc (B,)) ->
      (words (B, n_words) u32 sharded, nbits (B,) replicated — the
      replicated output sharding IS the all-gather of per-block bit
      lengths every participant needs for global splice offsets).
    B must be a multiple of the mesh size.  Built once per
    (mesh, n_words): a fresh jit wrapper per call would re-trace and
    re-load the executable every time (seconds on this backend).
    """
    key = ("enc", mesh, n_words, axis)
    if key not in _BUILT:
        import functools
        sh = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())
        _BUILT[key] = jax.jit(
            functools.partial(encode_batch_device, n_words=n_words),
            in_shardings=(sh, sh, sh, sh),
            out_shardings=(sh, rep))
    return _BUILT[key]


def build_sharded_decoder(mesh: Mesh, level: int, wt: int, G: int,
                          axis: str = "blocks"):
    """Returns a jitted SPMD block decoder over the mesh (the decode side
    of the block-DP axis; SURVEY §2.3 / BASELINE config #5).

    Each device runs the single-chip decode stages (ops/decode.py:
    group-parallel Huffman -> MTF^-1 -> RLE2 -> inverse BWT -> RLE1^-1 ->
    CRC) on its block shard.  Unlike the single-chip decoder's shared
    flat bit buffer, every block carries its own ``wt``-word row so the
    block axis shards cleanly.

    fn(words (B, wt) u32, goff (B, G) i32, gsel (B, G) i32,
       gvalid (B, G) bool, lens6 (B,6,258), alpha (B,), used_list, n_used,
       n_mtf, orig) -> (raw (B, NOUT) u8, out_len (B,), ok (B,))
    """
    from ..ops import decode as D

    N = 100_000 * level
    NOUT = N + N // 4 + 64

    # FOUR stage jits chained with explicit syncs, mirroring the
    # single-chip decoder (decoder.py).  Every array is batched on the
    # block axis (decode_symbols_rows keeps the bit buffer as per-block
    # rows), so each stage partitions along it cleanly.
    def grp_symbols(words, goff, gsel, gvalid, lens6, alpha):
        lut1, lut2, ebase = D.build_tables(lens6, alpha)
        return D.decode_symbols_rows(words, goff, gsel, gvalid, lut1,
                                     lut2, ebase)

    def grp_mtf(syms, used_list, n_used, n_mtf):
        vals = D.mtf_inverse(syms, used_list, n_used, n_mtf)
        return D.rle2_expand(syms, vals, n_used, n_mtf, N)

    def grp_tail(out, n_out, ok):
        raw, out_len, fits = D.rle1_inverse(out, n_out, NOUT)
        # no device CRC: the raw bytes are host-gathered for the splice
        # anyway, where the slice-by-8 C++ CRC checks them — the same
        # decision the single-chip decoder documents (decoder.py)
        return raw.astype(jnp.uint8), out_len, ok & fits

    # D.ibwt participates in the key: the jits trace it once, and tests
    # (and embedders) swap it to exercise the heal path — a stale cached
    # trace would silently keep the old budget
    key = ("dec", mesh, level, wt, G, axis, D.ibwt)
    if key not in _BUILT:
        sh = NamedSharding(mesh, P(axis))

        def J(f, n_in, n_out):
            return jax.jit(f, in_shardings=(sh,) * n_in,
                           out_shardings=(sh,) * n_out if n_out > 1 else sh)

        f_a = J(grp_symbols, 6, 1)
        f_m = J(grp_mtf, 4, 2)
        f_b = J(lambda l, n, o: D.ibwt(l, n, o), 3, 2)
        f_c = J(grp_tail, 3, 3)

        def pipeline(words, goff, gsel, gvalid, lens6, alpha,
                     used_list, n_used, n_mtf, orig):
            import os
            import sys
            import time
            b = jax.block_until_ready
            t0 = time.time()
            syms = b(f_a(words, goff, gsel, gvalid, lens6, alpha))
            t1 = time.time()
            last, n_out = b(f_m(syms, used_list, n_used, n_mtf))
            t2 = time.time()
            out, ok = b(f_b(last, n_out, orig))
            t3 = time.time()
            res = b(f_c(out, n_out, ok))
            if os.environ.get("BZ2TPU_MESH_TIMING"):
                sys.stderr.write(
                    f"[mesh-dec] symbols {t1-t0:.2f} mtf+rle2 {t2-t1:.2f} "
                    f"ibwt {t3-t2:.2f} tail {time.time()-t3:.2f}\n")
            return res

        _BUILT[key] = pipeline
    return _BUILT[key]


def decode_blocks_sharded(mesh, stream: bytes, level: int | None = None,
                          axis: str = "blocks"):
    """Decode all blocks of (possibly multi-member) .bz2 ``stream`` on the
    mesh, block-data-parallel.  Host does the light parse (native
    bz2tpu_parse_block) and the ordered splice + both CRC layers; every
    heavy stage runs sharded.  Returns the decompressed bytes.

    Raises ValueError on malformed input (callers with error-code
    contracts pre-validate via the host decoder)."""
    from .. import native
    from .. import constants as C
    from ..crc import combine_block_crcs

    buf = np.frombuffer(bytes(stream), np.uint8)
    total = buf.size * 8
    pos_bit = 0
    metas = []          # per block: ParsedBlock + word-row data
    member_crcs = []    # per member: list of stored block CRCs
    while True:
        if total - pos_bit < 32 or pos_bit % 8:
            raise ValueError("bad stream header")
        hdr = bytes(buf[pos_bit // 8: pos_bit // 8 + 4])
        if hdr[:3] != b"BZh" or not (0x31 <= hdr[3] <= 0x39):
            raise ValueError("bad stream header")
        lvl = hdr[3] - 0x30
        if level is None:
            level = lvl
        elif lvl != level:
            raise ValueError("mixed levels in stream")
        pos_bit += 32
        crcs = []
        while True:
            start_bit = pos_bit
            pb, rc = native.parse_block(buf, pos_bit, lvl)
            if pb is None:
                break
            if pb.randomised:
                raise ValueError("randomised legacy stream")
            pb.start_bit = start_bit
            metas.append(pb)
            crcs.append(pb.stored_crc)
            pos_bit = pb.end_bit
        member_crcs.append(crcs)
        # EOS: 48-bit magic + 32-bit combined CRC, then byte-align
        def bits(pos, k):
            v = 0
            for j in range(k):
                if (pos + j) >= total:
                    raise ValueError("truncated stream")
                v = (v << 1) | ((int(buf[(pos + j) // 8])
                                 >> (7 - (pos + j) % 8)) & 1)
            return v
        if bits(pos_bit, 48) != C.EOS_MAGIC:
            raise ValueError("bad end-of-stream magic")
        stored_comb = bits(pos_bit + 48, 32)
        if stored_comb != combine_block_crcs(crcs):
            raise ValueError("combined CRC mismatch")
        pos_bit += 48 + 32
        pos_bit = (pos_bit + 7) // 8 * 8
        if pos_bit // 8 + 4 <= buf.size and \
                bytes(buf[pos_bit // 8: pos_bit // 8 + 3]) == b"BZh":
            continue
        break
    if not metas:
        return b""

    from ..ops import decode as D
    d = mesh.devices.size
    B = len(metas)
    Bp = -(-B // d) * d
    G = max(pb.n_groups_used for pb in metas)
    need = max(((pb.end_bit + 31) // 32 + 1) - pb.sym_start_bit // 32
               for pb in metas)
    wt = 1 << max(6, need - 1).bit_length()

    words = np.zeros((Bp, wt), np.uint32)
    goff = np.zeros((Bp, G), np.int32)
    gsel = np.zeros((Bp, G), np.int32)
    gvalid = np.zeros((Bp, G), bool)
    lens6 = np.zeros((Bp, 6, 258), np.int32)
    alpha = np.full(Bp, 2, np.int32)
    used_list = np.zeros((Bp, 256), np.int32)
    n_used = np.ones(Bp, np.int32)
    n_mtf = np.ones(Bp, np.int32)
    orig = np.zeros(Bp, np.int32)
    for i, pb in enumerate(metas):
        wbase = pb.sym_start_bit // 32
        span = buf[wbase * 4: min(((pb.end_bit + 31) // 32 + 1) * 4,
                                  buf.size)]
        wbytes = np.zeros(wt * 4, np.uint8)
        wbytes[: span.size] = span
        words[i] = wbytes.view(">u4").astype(np.uint32)
        g = pb.n_groups_used
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

    fn = build_sharded_decoder(mesh, level, wt, G, axis=axis)
    raw, out_len, ok = fn(words, goff, gsel, gvalid, lens6, alpha,
                          used_list, n_used, n_mtf, orig)
    raw = np.asarray(raw)
    out_len = np.asarray(out_len)
    ok = np.asarray(ok)
    parts = []
    for i, pb in enumerate(metas):
        blk = raw[i, : int(out_len[i])].tobytes() if bool(ok[i]) else b""
        # block CRC on the gathered bytes (slice-by-8 C++, ~40x cheaper
        # than the GF(2) device fold this path used to run)
        if not bool(ok[i]) or native.crc32(blk) != pb.stored_crc:
            # lane anomaly (e.g. walker-cap on skewed cycles): heal this
            # block on the host, same policy as the single-chip decoder
            HEALS["lane"] += 1
            sl = np.ascontiguousarray(buf[: (pb.end_bit + 7) // 8])
            out, next_bit, _l, _c, _s, rc2 = native.decode_some(
                sl, pb.start_bit, level, 0)
            if out is None or next_bit != pb.end_bit:
                raise ValueError(f"block {i} failed sharded decode "
                                 f"(host rc={rc2})")
            parts.append(out)
            continue
        parts.append(blk)
    return b"".join(parts)


def encode_blocks_sharded(mesh, blocks_np, n_np, in_use_np, crc_np, n_words):
    """Host convenience: pad the batch to the mesh size, run the SPMD step,
    return (words (B,W) np.uint32, nbits (B,) np.int64) for the real blocks.

    Only the used word prefix crosses host-ward (bit lengths first — tiny
    and replicated — then a device-side slice, the same discipline as the
    single-chip engine's bucketed fetch): the full worst-case payload
    buffer is ~17 MB per 9-block batch of which ~1.5 MB is real."""
    d = mesh.devices.size
    B = blocks_np.shape[0]
    Bp = -(-B // d) * d
    if Bp != B:
        pad = Bp - B
        blocks_np = np.concatenate([blocks_np, np.zeros((pad,) + blocks_np.shape[1:], np.uint8)])
        n_np = np.concatenate([n_np, np.ones(pad, np.int32)])
        iu = np.zeros((pad, 256), bool)
        iu[:, 0] = True
        in_use_np = np.concatenate([in_use_np, iu])
        crc_np = np.concatenate([crc_np, np.zeros(pad, np.uint32)])
    fn = build_sharded_encoder(mesh, n_words)
    words, nbits = fn(blocks_np, n_np.astype(np.int32), in_use_np, crc_np)
    nbits_np = np.asarray(nbits)
    need = int((int(nbits_np.max()) + 31) // 32)
    bucket = min(1 << max(10, need - 1).bit_length(), n_words)
    key = (words.shape, bucket)
    if key not in _SLICERS:
        import functools
        _SLICERS[key] = jax.jit(functools.partial(
            lambda w, k: w[:, :k], k=bucket))
    out = np.zeros((Bp, n_words), np.uint32)
    out[:, :bucket] = np.asarray(_SLICERS[key](words))
    return out[:B], nbits_np[:B]
