"""Batched MTF + RLE2.

MTF rank of position i equals the number of distinct symbols whose last
occurrence (over the prefix before i, with virtual initial occurrences
encoding the initial list order) is more recent than that of the current
symbol.  We compute running 256-wide last-occurrence tables tile-by-tile
with ``lax.cummax`` inside a ``lax.scan`` — elementwise work with no
sequential per-symbol dependency (semantics: reference generateMTFValues,
compress.c:94-229; validated against bzip2_tpu.oracle.mtf).

Zero-runs are then re-coded as RUNA/RUNB (bijective base-2) with a
prefix-sum stream compaction; output is padded to M = N + 1 (MTF never
expands: a zero-run of Z emits <= Z symbols).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_NEG = np.int32(-(1 << 30))


def mtf_ranks_batched(seq: jnp.ndarray, valid: jnp.ndarray, tile: int = 512):
    """seq: int32 (B, N) remapped symbols (0..255); valid: bool (B, N).
    Returns int32 (B, N) MTF list positions (pad positions garbage).

    On a GPU the ranks come from the tiled kernel in ``mtf_gpu``; every
    other backend runs ``mtf_ranks_xla``, which is also its reference.
    """
    if jax.default_backend() == "gpu":
        from .mtf_gpu import mtf_ranks_gpu
        return mtf_ranks_gpu(seq, valid)
    return mtf_ranks_xla(seq, valid, tile=tile)


def mtf_ranks_xla(seq: jnp.ndarray, valid: jnp.ndarray, tile: int = 512,
                  step_bytes: int = 128 << 20):
    """Plain-XLA MTF ranks; same contract as ``mtf_ranks_batched``.

    Two-level structure: tiles are processed *in parallel* (the carry
    between tiles is an associative prefix-max of per-symbol last
    occurrences, kept at tile granularity in int32), while all per-position
    work inside a tile runs in int16 — within-tile occurrence times fit
    i16, halving the traffic of the dominant (T, 256) buffers.  rank[i]
    splits as:

      cur seen in tile prefix:   #{s: excl16[s] > excl16[cur]}
      cur not in tile prefix:    #{s seen in prefix}          (all beat cur)
                               + #{s unseen: L[s] > L[cur]}   (tile carries)

    A short outer ``lax.scan`` bounds peak memory (each step materializes
    ~step_bytes of (B, tiles, tile, 256) intermediates).
    """
    B, N = seq.shape
    assert N % tile == 0, "pad N to a multiple of the MTF tile"
    assert tile < (1 << 15)
    n_tiles = N // tile
    # Choose the number of tiles per outer step from the memory budget.
    per_tile_bytes = B * tile * 256 * 2
    tiles_per_step = max(1, min(n_tiles, step_bytes // max(per_tile_bytes, 1)))
    n_steps = -(-n_tiles // tiles_per_step)
    pad_tiles = n_steps * tiles_per_step - n_tiles

    # Virtual initial occurrence times: symbol j at time -(j+1).
    last0 = jnp.broadcast_to(-(jnp.arange(256, dtype=jnp.int32) + 1), (B, 256))

    seq_p = jnp.pad(seq.reshape(B, n_tiles, tile), ((0, 0), (0, pad_tiles), (0, 0)))
    val_p = jnp.pad(valid.reshape(B, n_tiles, tile), ((0, 0), (0, pad_tiles), (0, 0)))
    C = tiles_per_step
    seq_t = seq_p.reshape(B, n_steps, C, tile).transpose(1, 0, 2, 3)
    val_t = val_p.reshape(B, n_steps, C, tile).transpose(1, 0, 2, 3)
    base_t = (jnp.arange(n_steps * C, dtype=jnp.int32) * tile
              ).reshape(n_steps, 1, C)                    # tile start offsets

    sym_ids = jnp.arange(256, dtype=jnp.int32)
    iota16 = jnp.arange(tile, dtype=jnp.int16)[None, None, :, None]
    neg1_16 = jnp.int16(-1)

    def step(carry, inputs):
        s, v, base = inputs                      # (B,C,T), (B,C,T), (1,C)
        onehot = (s[..., None] == sym_ids) & v[..., None]
        occ16 = jnp.where(onehot, iota16, neg1_16)
        incl16 = lax.cummax(occ16, axis=2)       # (B,C,T,256) i16
        excl16 = jnp.concatenate(
            [jnp.full((B, C, 1, 256), neg1_16), incl16[:, :, :-1, :]], axis=2)
        cur16 = jnp.take_along_axis(excl16, s[..., None], axis=3)
        within = jnp.sum(excl16 > cur16, axis=3, dtype=jnp.int32)

        # tile-granular carries (global last occurrence before each tile)
        tile_last16 = incl16[:, :, -1, :]        # (B,C,256)
        tl32 = jnp.where(tile_last16 >= 0,
                         base[..., None] + tile_last16.astype(jnp.int32), _NEG)
        shifted = jnp.concatenate([carry[:, None, :], tl32[:, :-1, :]], axis=1)
        Lx = lax.cummax(shifted, axis=1)         # (B,C,256) exclusive
        prvL = jnp.take_along_axis(Lx, s, axis=2)           # (B,C,T)
        cross = jnp.sum((excl16 < 0) & (Lx[:, :, None, :] > prvL[..., None]),
                        axis=3, dtype=jnp.int32)
        ranks = jnp.where(cur16[..., 0] >= 0, within, within + cross)
        new_carry = jnp.maximum(Lx[:, -1, :], tl32[:, -1, :])
        return new_carry, ranks

    _, ranks = lax.scan(step, last0, (seq_t, val_t, base_t))
    ranks = ranks.transpose(1, 0, 2, 3).reshape(B, n_steps * C * tile)
    return ranks[:, :N]


def mtf_rle2_batched(last_col: jnp.ndarray, n: jnp.ndarray, in_use: jnp.ndarray,
                     tile: int = 512):
    """last_col: uint8 (B, N) BWT output; n: int32 (B,); in_use: bool (B, 256).

    Returns (mtfv int32 (B, N+1), n_mtf int32 (B,), n_in_use int32 (B,)).
    mtfv pad positions are 0.  (Symbol frequencies are derived by callers
    from the per-group histogram: ``build_group_hist(...).sum(axis=1)``.)

    The RLE2 expansion is gather-formulated: every "source" (a nonzero MTF
    rank, or the EOB) owns an output span [offs, offs + dcount] holding the
    bijective base-2 digits of its preceding zero-run length then its
    symbol.  Three packed scatter-max+cummax passes propagate each
    source's (offs, symbol, run length m) to every slot it covers; each
    slot then derives its value locally (max is order-independent, so
    duplicate scatter indices are harmless).
    """
    B, N = last_col.shape
    M = N + 1
    assert M < (1 << 20), "offset packing assumes block size < 2^20"
    idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    valid = idx < n[:, None]

    # Remap bytes onto the used-symbol alphabet.
    in_use_i = in_use.astype(jnp.int32)
    remap = jnp.cumsum(in_use_i, axis=1) - in_use_i  # index among used symbols
    n_in_use = jnp.sum(in_use_i, axis=1)
    seq = jnp.take_along_axis(remap, last_col.astype(jnp.int32), axis=1)
    seq = jnp.where(valid, seq, 0)

    ranks = mtf_ranks_batched(seq, valid, tile=tile)
    ranks = jnp.where(valid, ranks, 0)

    # --- RLE2 stream layout ---
    nonzero = (ranks > 0) & valid
    # prev nonzero position before i (exclusive), -1 if none
    marks = jnp.where(nonzero, idx, -1)
    prev_incl = lax.cummax(marks, axis=1)
    prev_excl = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), prev_incl[:, :-1]], axis=1)
    zlen = jnp.where(nonzero, idx - prev_excl - 1, 0)            # (B, N)
    m = zlen + 1
    # digit count = bit_length(m) - 1 = floor(log2(m))
    dcount = (31 - lax.clz(m.astype(jnp.int32))).astype(jnp.int32)
    dcount = jnp.where(nonzero, dcount, 0)
    counts = jnp.where(nonzero, dcount + 1, 0)                   # digits + sym

    # tail zero-run + EOB as one more source (uniform: dcount digits + sym)
    last_nz = prev_incl[:, -1]
    tail_z = jnp.where(n > 0, n - 1 - last_nz, 0)
    tail_m = tail_z + 1
    tail_d = jnp.where(tail_z > 0,
                       (31 - lax.clz(tail_m.astype(jnp.int32))).astype(jnp.int32), 0)

    offs = jnp.cumsum(counts, axis=1) - counts                   # exclusive
    total_body = offs[:, -1] + counts[:, -1]
    n_mtf = total_body + tail_d + 1                              # + EOB

    # Pack per-source fields keyed by offs so cummax propagates the covering
    # source to every slot: offs < 2^20, sym <= 257 (10 bits), m < 2^20
    # split as 11 low + 9 high bits.
    sym = ranks + 1
    pos = jnp.where(nonzero, offs, M - 1)                        # dump -> M-1
    v_sym = jnp.where(nonzero, (offs << 10) | sym, 0)
    v_mlo = jnp.where(nonzero, (offs << 11) | (m & 0x7FF), 0)
    v_mhi = jnp.where(nonzero, (offs << 10) | (m >> 11), 0)

    br = jnp.arange(B, dtype=jnp.int32)
    eob_sym = n_in_use + 1

    def spread(vals, eob_val):
        a = jnp.zeros((B, M), jnp.int32).at[br[:, None], pos].max(vals)
        a = a.at[br, total_body].max(eob_val)
        return lax.cummax(a, axis=1)

    s_sym = spread(v_sym, (total_body << 10) | eob_sym)
    s_mlo = spread(v_mlo, (total_body << 11) | (tail_m & 0x7FF))
    s_mhi = spread(v_mhi, (total_body << 10) | (tail_m >> 11))

    p = jnp.arange(M, dtype=jnp.int32)[None, :]
    start = s_sym >> 10
    slot_sym = s_sym & 0x3FF
    slot_m = ((s_mhi & 0x3FF) << 11) | (s_mlo & 0x7FF)
    d = jnp.clip(p - start, 0, 31)
    dc = 31 - lax.clz(jnp.maximum(slot_m, 1))
    out = jnp.where(d == dc, slot_sym, (slot_m >> d) & 1)

    out_valid = p < n_mtf[:, None]
    out = jnp.where(out_valid, out, 0)
    return out, n_mtf, n_in_use
