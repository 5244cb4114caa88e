"""MTF ranks on the GPU: a Pallas kernel through Triton for the within-tile
ranks, with the cross-tile carry in XLA.

The sequence is cut into tiles of ``T`` symbols.  XLA computes, for every
tile, the MTF list as it stands when the tile starts: the last occurrence
of each symbol before the tile (a scatter-max per tile, then a cummax
across tiles) ranked by recency.  Each symbol is renamed to its position
``g`` in that list, so the kernel needs no 256-wide state: within a tile,
with ``p`` the previous in-tile occurrence of the current symbol,

  p exists:   rank = #{distinct symbols in (p, i)}
  otherwise:  rank = g_i + #{distinct symbols in [0, i) with g > g_i}

and "distinct symbols in a window" counts the positions j in it that are
the last occurrence of their symbol before i.  That is a T x T compare
per tile held in registers; device memory sees 4 bytes in and 4 out per
symbol plus the per-tile list tables.

Semantics are those of ``mtf.mtf_ranks_xla`` (reference generateMTFValues,
compress.c:94-229): invalid positions are not occurrences and their ranks
are garbage.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_NEG = np.int32(-(1 << 30))
#: symbols per program and warps per program: the fastest of T in
#: {64, 128, 256} x warps in {1, 2, 4, 8} at 13 x 901,120 on an H100
#: (T=128 with one warp; T=256 spills the T x T working set)
TILE = 128
NUM_WARPS = 1


def _rank_kernel(g_ref, o_ref):
    g = g_ref[...]                                   # (R, T); -1 = invalid
    R, T = g.shape
    ii = lax.broadcasted_iota(jnp.int32, (R, T, T), 1)
    jj = lax.broadcasted_iota(jnp.int32, (R, T, T), 2)
    gi = g[:, :, None]
    gj = g[:, None, :]
    before = (jj < ii) & (gj >= 0)
    same = before & (gi == gj)
    prev = jnp.max(jnp.where(same, jj, -1), axis=2)            # (R, T)
    # nxt[j]: next in-tile occurrence of g_j after j (T if none)
    nxt = jnp.min(jnp.where(same, ii, T), axis=1)              # (R, T)
    last = before & (nxt[:, None, :] >= ii)
    within = jnp.sum((last & (jj > prev[:, :, None])).astype(jnp.int32),
                     axis=2)
    fresh = g + jnp.sum((last & (gj > gi)).astype(jnp.int32), axis=2)
    o_ref[...] = jnp.where(prev >= 0, within, fresh)


def _tile_lists(seq, valid, T: int):
    """Per-tile MTF list at tile start: (B, n_tiles, 256) int32 position
    of each symbol."""
    B, N = seq.shape
    nt = N // T
    s3 = jnp.where(valid, seq, 256).reshape(B, nt, T)      # 256 = dump
    bi = lax.broadcasted_iota(jnp.int32, s3.shape, 0)
    ti = lax.broadcasted_iota(jnp.int32, s3.shape, 1)
    pos = lax.broadcasted_iota(jnp.int32, s3.shape, 2)
    # scatter-max is order-independent, so duplicate indices are harmless
    tl = jnp.full((B, nt, 257), -1, jnp.int32).at[bi, ti, s3].max(pos)
    tl = tl[..., :256]
    base = (jnp.arange(nt, dtype=jnp.int32) * T)[None, :, None]
    tl32 = jnp.where(tl >= 0, base + tl, _NEG)
    # exclusive carry, seeded with the virtual initial list: symbol j at
    # time -(j+1); every symbol's last-occurrence time is distinct
    init = jnp.broadcast_to(-(jnp.arange(256, dtype=jnp.int32) + 1),
                            (B, 1, 256))
    lx = lax.cummax(jnp.concatenate([init, tl32[:, :-1]], axis=1), axis=1)
    sym = lax.broadcasted_iota(jnp.int32, lx.shape, 2)
    _, order = lax.sort((-lx, sym), dimension=2, num_keys=1)  # by recency
    _, lists = lax.sort((order, sym), dimension=2, num_keys=1)  # inverse
    return lists


@functools.partial(jax.jit, static_argnames=("interpret",))
def mtf_ranks_gpu(seq: jnp.ndarray, valid: jnp.ndarray,
                  interpret: bool = False):
    """seq: int32 (B, N) symbols 0..255; valid: bool (B, N).
    Returns int32 (B, N) MTF ranks (invalid positions garbage).
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests)."""
    B, N = seq.shape
    Np = -(-N // TILE) * TILE
    seq_p = jnp.pad(seq, ((0, 0), (0, Np - N)))
    val_p = jnp.pad(valid, ((0, 0), (0, Np - N)))
    nt = Np // TILE
    lists = _tile_lists(seq_p, val_p, TILE)
    g = jnp.take_along_axis(lists, seq_p.reshape(B, nt, TILE), axis=2)
    g = jnp.where(val_p.reshape(B, nt, TILE), g, -1).reshape(B * nt, TILE)
    ranks = pl.pallas_call(
        _rank_kernel,
        out_shape=jax.ShapeDtypeStruct((B * nt, TILE), jnp.int32),
        grid=(B * nt,),
        in_specs=[pl.BlockSpec((1, TILE), lambda r: (r, 0))],
        out_specs=pl.BlockSpec((1, TILE), lambda r: (r, 0)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="mtf_tile_ranks",
    )(g)
    return ranks.reshape(B, Np)[:, :N]
