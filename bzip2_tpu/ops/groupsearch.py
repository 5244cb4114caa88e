"""Batched greedy 6-table group search (reference sendMTFValues,
compress.c:251-561) as batched matmuls.

Key reformulation: per-50-symbol-group symbol histograms ``hist`` are
selector-invariant, so they are built once per block; then each refinement
pass is two small matmuls —

  cost[b,g,t] = hist[b,g,:] @ lens[b,t,:]   (bf16 inputs, f32 accumulate;
  freq[b,t,:] = onehot(sel)[b,:,t] @ hist    all quantities are small
                                             integers, so f32 is exact)

— plus an argmin (first minimum wins ties, matching the reference's strict
``<`` scan) and the exact-heap Huffman rebuild.  Selector MTF reuses the
last-occurrence rank formulation over the 6-symbol alphabet.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import (G_SIZE, GREATER_ICOST, LESSER_ICOST, MAX_ALPHA_SIZE,
                         N_ITERS)
from .huffman import assign_codes_lanes, make_code_lengths_lanes
from .mtf import mtf_ranks_batched

A = MAX_ALPHA_SIZE


def n_groups_batched(n_mtf: jnp.ndarray) -> jnp.ndarray:
    return (2 + (n_mtf >= 200).astype(jnp.int32) + (n_mtf >= 600).astype(jnp.int32)
            + (n_mtf >= 1200).astype(jnp.int32) + (n_mtf >= 2400).astype(jnp.int32))


def initial_tables_batched(freq: jnp.ndarray, n_mtf: jnp.ndarray,
                           alpha: jnp.ndarray, n_groups: jnp.ndarray) -> jnp.ndarray:
    """Frequency-partition seeding (compress.c:276-319).  freq: (B, A) int32.
    Returns lens (B, 6, A) int32."""
    B = freq.shape[0]
    cum = jnp.cumsum(freq, axis=1)                       # (B, A) inclusive
    arange = jnp.arange(A, dtype=jnp.int32)[None, :]

    def step(carry, part_idx):
        gs, rem_f, lens = carry
        n_part = n_groups - part_idx                      # (B,)
        active = n_part >= 1
        t_freq = jnp.where(n_part > 0, rem_f // jnp.maximum(n_part, 1), 0)
        prev_cum = jnp.where(gs > 0,
                             jnp.take_along_axis(cum, jnp.maximum(gs - 1, 0)[:, None],
                                                 axis=1)[:, 0], 0)
        target = prev_cum + t_freq
        # ge = first index >= gs with cum >= target, clamped to A-1...
        # except tFreq <= 0 leaves ge = gs - 1 (possibly empty span).
        hit = jnp.logical_and(arange >= gs[:, None], cum >= target[:, None])
        any_hit = jnp.any(hit, axis=1)
        first_hit = jnp.argmax(hit, axis=1).astype(jnp.int32)
        ge = jnp.where(any_hit, first_hit, A - 1)
        # reference bounds the scan at alphaSize-1 of the *actual* alphabet
        ge = jnp.minimum(ge, alpha - 1)
        ge = jnp.where(t_freq <= 0, gs - 1, ge)
        ge = jnp.maximum(ge, gs - 1)
        # parity adjustment (compress.c:297-301)
        adjust = jnp.logical_and(
            jnp.logical_and(ge > gs, part_idx > 0),
            jnp.logical_and(n_part != 1, (part_idx % 2) == 1))
        ge = jnp.where(adjust, ge - 1, ge)
        a_freq = jnp.where(
            ge >= gs,
            jnp.take_along_axis(cum, jnp.maximum(ge, 0)[:, None], axis=1)[:, 0] - prev_cum,
            0)
        span = jnp.logical_and(arange >= gs[:, None], arange <= ge[:, None])
        span = jnp.logical_and(span, active[:, None])
        row = jnp.maximum(n_part - 1, 0)                  # table index
        upd = jnp.where(span, LESSER_ICOST, GREATER_ICOST)
        lens = lens.at[jnp.arange(B), row].set(
            jnp.where(span, jnp.int32(LESSER_ICOST),
                      lens[jnp.arange(B), row]))
        gs = jnp.where(active, ge + 1, gs)
        rem_f = jnp.where(active, rem_f - a_freq, rem_f)
        return (gs, rem_f, lens), None

    lens0 = jnp.full((B, 6, A), GREATER_ICOST, jnp.int32)
    gs0 = jnp.zeros(B, jnp.int32)
    (gs, rem, lens), _ = lax.scan(step, (gs0, n_mtf, lens0),
                                  jnp.arange(6, dtype=jnp.int32))
    return lens


def build_group_hist(mtfv: jnp.ndarray, n_mtf: jnp.ndarray):
    """(B, M) symbols -> (B, G, A) per-50-group histograms (int32).

    One-hot + segment-sum instead of a scatter-add; XLA fuses the one-hot
    producer into the reduction.  Counts <= 50 are exact in
    bfloat16-in/f32-accumulate."""
    B, M = mtfv.shape
    G = -(-M // G_SIZE)
    pad = G * G_SIZE - M
    syms = jnp.pad(mtfv, ((0, 0), (0, pad)))
    valid = jnp.arange(G * G_SIZE, dtype=jnp.int32)[None, :] < n_mtf[:, None]
    onehot = ((syms[:, :, None] == jnp.arange(A, dtype=jnp.int32))
              & valid[:, :, None])
    hist = jnp.sum(onehot.reshape(B, G, G_SIZE, A).astype(jnp.bfloat16),
                   axis=2, dtype=jnp.float32)
    return hist.astype(jnp.int32)


def group_iter(hist_bf, lens, table_invalid):
    """One refinement pass: (B,G,A) bf16 hist, (B,6,A) int32 lens ->
    (selectors (B,G) int32, freq6 (B,6,A) int32)."""
    cost = jax.lax.dot_general(
        hist_bf, lens.astype(jnp.bfloat16),
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    cost = cost + jnp.where(table_invalid, 1e9, 0.0)[:, None, :]
    selectors = jnp.argmin(cost, axis=2).astype(jnp.int32)
    onehot = (selectors[:, :, None] == jnp.arange(6, dtype=jnp.int32)[None, None, :])
    freq6 = jax.lax.dot_general(
        onehot.astype(jnp.bfloat16), hist_bf,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    return selectors, freq6


def selector_mtf(selectors, n_selectors):
    """MTF-code the selector stream; returns (B,G) values in 1..6 (0 pad)."""
    B, G = selectors.shape
    tile = 64
    Gp = -(-G // tile) * tile
    sel_pad = jnp.pad(selectors, ((0, 0), (0, Gp - G)))
    gvalid = jnp.arange(Gp, dtype=jnp.int32)[None, :] < n_selectors[:, None]
    ranks = mtf_ranks_batched(sel_pad, gvalid, tile=tile)
    return jnp.where(gvalid[:, :G], ranks[:, :G] + 1, 0)


def group_search_batched(mtfv, n_mtf, n_in_use):
    """Returns (n_groups (B,), n_selectors (B,), selectors (B, G),
    sel_mtf (B, G) MTF-coded selector values (1..6), lens (B,6,A),
    codes (B,6,A))."""
    B, M = mtfv.shape
    alpha = n_in_use + 2
    n_groups = n_groups_batched(n_mtf)
    n_selectors = -(-n_mtf // G_SIZE)

    hist = build_group_hist(mtfv, n_mtf)                  # (B, G, A)
    freq = jnp.sum(hist, axis=1)                          # (B, A)
    lens = initial_tables_batched(freq, n_mtf, alpha, n_groups)
    hist_bf = hist.astype(jnp.bfloat16)
    G = hist.shape[1]
    table_invalid = (jnp.arange(6, dtype=jnp.int32)[None, :] >= n_groups[:, None])

    selectors = jnp.zeros((B, G), jnp.int32)
    for _ in range(N_ITERS):
        selectors, new_freq = group_iter(hist_bf, lens, table_invalid)
        lens = make_code_lengths_lanes(
            new_freq.reshape(B * 6, A),
            jnp.broadcast_to(alpha[:, None], (B, 6)).reshape(B * 6)
        ).reshape(B, 6, A)

    codes = assign_codes_lanes(lens.reshape(B * 6, A),
                               jnp.broadcast_to(alpha[:, None], (B, 6)).reshape(B * 6)
                               ).reshape(B, 6, A)
    sel_mtf = selector_mtf(selectors, n_selectors)
    return n_groups, n_selectors, selectors, sel_mtf, lens, codes
