"""Variable-length bit packing on device.

A compressed block is a sequence of (value, nbits) fields (nbits may be 0
for inactive slots).  An exclusive prefix sum gives each field's bit offset;
each field straddles at most two 32-bit words, so two disjoint-bit
scatter-adds materialize the stream (adds == ORs: bit regions never
overlap).  Shifts are decomposed into explicit 32-bit halves so no 64-bit
integers are required.  Mirrors ``bitstream.BitWriter.write_codes`` on host.
"""
from __future__ import annotations

import jax.numpy as jnp


def pack_fields(vals: jnp.ndarray, lens: jnp.ndarray, n_words: int):
    """vals: (B, F) uint32 (< 2**lens); lens: (B, F) int32 in 0..32.

    Returns (words (B, n_words) uint32 big-endian bit order, total_bits (B,)).
    """
    B, F = vals.shape
    lens = lens.astype(jnp.int32)
    csum = jnp.cumsum(lens, axis=1)
    offs = csum - lens
    total_bits = csum[:, -1]

    w = offs >> 5
    r = offs & 31
    s = 64 - r - lens                       # left shift within the 64-bit window
    code = jnp.where(lens > 0, vals.astype(jnp.uint32), jnp.uint32(0))
    hi_shift = jnp.clip(s - 32, 0, 31).astype(jnp.uint32)
    lo_rshift = jnp.clip(32 - s, 0, 31).astype(jnp.uint32)
    lo_lshift = jnp.clip(s, 0, 31).astype(jnp.uint32)
    hi = jnp.where(s >= 32, code << hi_shift, code >> lo_rshift)
    lo = jnp.where(s >= 32, jnp.uint32(0), code << lo_lshift)

    flat = jnp.zeros(B * n_words, jnp.uint32)
    base = jnp.arange(B, dtype=jnp.int32)[:, None] * n_words
    # offsets are nondecreasing within a lane and lanes are disjoint, so
    # both flattened index streams are sorted — declare it
    flat = flat.at[(base + w).reshape(-1)].add(
        hi.reshape(-1), indices_are_sorted=True)
    flat = flat.at[(base + w + 1).reshape(-1)].add(
        lo.reshape(-1), indices_are_sorted=True)
    return flat.reshape(B, n_words), total_bits
