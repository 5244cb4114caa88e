"""Batched BWT rotation sort: one wide-key sort, one (usually) full-width
doubling pass, then sort-compacted tail refinement.

The reference's divsufsort (blocksort.c:1503-1545) is an irregular pointer
machine; the batched design is fully-parallel prefix doubling over the
cyclic rotations, built from whole-array sorts, rolls and cumulative
scans:

  1. **16-byte initial ranks** from one 4-key *unstable* ``lax.sort``
     (keys built with static rolls over a cyclically-extended byte
     buffer — no gathers).  Gapped ranks are tie-class properties, so
     stability buys nothing.
  2. **Gapped ranks** (rank = sorted index of the first member of a tie
     class).  Rank maps back to position space via a 1-key sort.
  3. **One full-width x2 doubling pass** (k=16 -> 32) using a *roll* for
     the neighbour ranks (the pad region past each block mirrors
     ``rank[0:]``, so a static roll realizes the cyclic shift).  On real
     text this single pass drops the unresolved set under N/4
     (tools/bwt_stats.py trajectory); on adversarial periodic blocks the
     loop keeps doubling at full width — graceful, still O(log n) passes.
  4. **Sort-compacted tail**: the tied survivors are packed by one keyed
     sort + slice, then refined in geometrically shrinking power-of-two
     buffers with per-pass neighbour gathers touching only the
     unresolved set.  Recompaction between buckets is again sort+slice.

These substitutions (sorts and rolls in place of scatters and gathers)
were chosen from an earlier accelerator's primitive costs; they are not
yet re-measured on the H100.

Every sort here is unstable: each caller either sorts all-distinct keys
or only reads tie-class properties, so the order of equal keys never
reaches the output.

Blocks are padded to a common static N; pad positions sort to the tail.
origPtr follows the tie policy documented in ``bzip2_tpu.oracle.bwt``
(last in-class slot; matches stock on regular periodic families and on
all distinct-rotation blocks).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

INF = np.int32(0x7FFFFFFF)
_INIT_BYTES = 16          # initial rank depth (4 packed u32 keys)
_MIRROR = 2048            # static width of the pad-mirror region


def _pack4(p0, p1, p2, p3):
    """Four byte planes -> one sign-biased int32 sort key (unsigned order)."""
    k = (p0 << 24) | (p1 << 16) | (p2 << 8) | p3
    return k ^ jnp.int32(-0x80000000)


def _gapped_rerank(order, key_cols):
    """From sorted key columns, compute per-position gapped ranks and tie
    flags.  order: (B, S) original positions of the sorted entries (may be
    a compact subset); key_cols: list of (B, S) sorted key columns.

    Returns (start (B,S) int32 gapped rank per sorted entry,
             singleton (B,S) bool)."""
    B, S = order.shape
    j = jnp.arange(S, dtype=jnp.int32)[None, :]
    changed = jnp.zeros((B, S), bool).at[:, 0].set(True)
    for c in key_cols:
        changed = changed | jnp.concatenate(
            [jnp.ones((B, 1), bool), c[:, 1:] != c[:, :-1]], axis=1)
    start = lax.cummax(jnp.where(changed, j, 0), axis=1)
    nxt = jnp.concatenate([changed[:, 1:], jnp.ones((B, 1), bool)], axis=1)
    singleton = changed & nxt
    return start, singleton


def _scatter_rank(order, start, singleton, valid, n, N, mirror=True):
    """Map gapped ranks (packed with tie flags) back to position space via
    a 1-key sort, refresh the pad-mirror region, and return
    (rank (B,N), tied (B,N), unres (B,))."""
    B = order.shape[0]
    br = jnp.arange(B, dtype=jnp.int32)[:, None]
    v = (start << 1) | singleton.astype(jnp.int32)
    # inverse-permutation apply via a 1-key sort (keys are distinct)
    _, packed = lax.sort((order, v), dimension=1, is_stable=False, num_keys=1)
    rank = packed >> 1
    tied = jnp.logical_not(packed & 1) & valid
    unres = jnp.sum(tied.astype(jnp.int32), axis=1)
    if mirror:
        ms = min(_MIRROR, N)
        jm = jnp.arange(ms, dtype=jnp.int32)[None, :]
        # overwrite the pad region with a cyclic mirror of rank[0:ms] so a
        # static roll can realize rank[(i+k) mod n] while k <= slack.
        # Mirror slots past the lane end go to a dump column at N: every
        # kept target is distinct, so no two updates race for one slot
        # (the winner among duplicate scatter indices is unspecified).
        keep = (n[:, None] + jm) < N
        rank = jnp.concatenate([rank, jnp.zeros((B, 1), jnp.int32)], axis=1)
        rank = rank.at[br, jnp.where(keep, n[:, None] + jm, N)].set(
            rank[:, :ms])[:, :N]
    return rank, tied, unres


def _tail_ladder(N: int) -> list[int]:
    """Power-of-two compact-buffer widths, sized to the measured
    unresolved-set trajectory on real text (tools/bwt_stats.py): one
    full-width pass leaves < N/4 survivors, then each tail pass roughly
    halves or quarters the set."""
    def p2(x):
        return 1 << (max(x, 1) - 1).bit_length()
    c = p2(max(N // 4, 128))
    ladder = [c, c // 2, c // 4, c // 16, c // 64]
    out: list[int] = []
    for x in ladder:
        x = max(x, 128)
        if not out or x < out[-1]:
            out.append(x)
    return out


def _compact_by_sort(key, payload, cap):
    """Pack the entries with key < INF into the first ``cap`` columns
    (ordered by key) via one keyed sort + slice.  Returns (p, r1) where
    dead slots are (-1, INF).  key must be distinct where live; caller
    guarantees the live count fits ``cap``."""
    ks, vs = lax.sort((key, payload), dimension=1, is_stable=False,
                      num_keys=1)
    ks = ks[:, :cap]
    vs = vs[:, :cap]
    live = ks < INF
    return jnp.where(live, ks, -1), jnp.where(live, vs, INF)


def bwt_batched(blocks: jnp.ndarray, n: jnp.ndarray):
    """blocks: uint8 (B, N); n: int32 (B,) true lengths (>= 1).

    Returns (last uint8 (B, N), orig_ptr int32 (B,), sa int32 (B, N)).
    Pad positions of ``last`` are 0.
    """
    B, N = blocks.shape
    idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    idx_b = jnp.broadcast_to(idx, (B, N))
    valid = idx < n[:, None]
    nn = jnp.maximum(n[:, None], 1)
    br = jnp.arange(B, dtype=jnp.int32)[:, None]
    min_slack = N - jnp.max(n)          # roll fast path bound (may be 0)

    # --- cyclically-extended byte buffer: bx[i] = block[i mod n] for
    # i < n + 16 (works for any n >= 1 via the mod-n wrap gather).
    bi = jnp.where(valid, blocks, 0).astype(jnp.int32)
    wrap = jnp.take_along_axis(
        bi, jnp.remainder(jnp.arange(_INIT_BYTES, dtype=jnp.int32)[None, :], nn),
        axis=1)                                              # (B, 16)
    bx = jnp.concatenate([bi, jnp.zeros((B, _INIT_BYTES), jnp.int32)], axis=1)
    ext_j = jnp.arange(_INIT_BYTES, dtype=jnp.int32)[None, :]
    bx = bx.at[br, n[:, None] + ext_j].set(wrap)

    # --- 16-byte initial keys from static rolls (no gathers).  Only the
    # first packed word needs byte planes; the other three are 4/8/12-
    # position rolls of it over the extended width (ext covers the wrap).
    p0 = bx
    p1 = jnp.roll(bx, -1, axis=1)
    p2 = jnp.roll(bx, -2, axis=1)
    p3 = jnp.roll(bx, -3, axis=1)
    k1x = _pack4(p0, p1, p2, p3)                 # (B, N+16)
    keys = [
        jnp.where(valid, kx[:, :N], INF)
        for kx in (k1x, jnp.roll(k1x, -4, axis=1), jnp.roll(k1x, -8, axis=1),
                   jnp.roll(k1x, -12, axis=1))
    ]
    # unstable: gapped ranks are tie-class properties, so the intra-class
    # payload order is irrelevant (and unstable sorts are ~30% cheaper)
    sorted_ops = lax.sort(tuple(keys) + (idx_b,), dimension=1,
                          is_stable=False, num_keys=len(keys))
    order = sorted_ops[-1]
    start, singleton = _gapped_rerank(order, list(sorted_ops[:-1]))
    rank, tied, unres = _scatter_rank(order, start, singleton, valid, n, N)

    ladder = _tail_ladder(N)
    cap0 = ladder[0]

    # ---------------- stage 1: full-width doubling passes ----------------
    # On real text ONE pass (k=16 -> 32) drops the unresolved set under
    # cap0; periodic/degenerate blocks keep doubling at full width.
    def neighbour_ranks(rank, k):
        """rank[(i+k) mod n] for all positions (roll fast path when the pad
        mirror covers the shift)."""
        def via_roll(_):
            return jnp.roll(rank, -k, axis=1)

        def via_gather(_):
            return jnp.take_along_axis(rank, jnp.remainder(idx + k, nn), axis=1)

        return lax.cond(k <= jnp.minimum(min_slack, _MIRROR), via_roll,
                        via_gather, 0)

    def full_cond(state):
        _, _, k, unres = state
        return jnp.logical_and(k < N, jnp.any(unres > cap0))

    def full_body(state):
        rank, tied, k, _ = state
        r1 = jnp.where(valid, rank, INF)
        r2 = jnp.where(valid, neighbour_ranks(rank, k), INF)
        r1s, r2s, order = lax.sort(
            (r1, r2, idx_b), dimension=1, is_stable=False, num_keys=2)
        start, singleton = _gapped_rerank(order, [r1s, r2s])
        rank, tied, unres = _scatter_rank(order, start, singleton, valid, n, N)
        return rank, tied, k * 2, unres

    k0 = jnp.int32(_INIT_BYTES)
    rank, tied, k, unres = lax.while_loop(
        full_cond, full_body, (rank, tied, k0, unres))

    # -------------- stages 2+: compact tail refinement --------------
    # rankD gets a dump column at N for discarded scatter lanes.
    rankD = jnp.concatenate([rank, jnp.full((B, 1), N, jnp.int32)], axis=1)
    p_buf, r_buf = _compact_by_sort(jnp.where(tied, idx_b, INF), rank, cap0)

    def tail_stage(rankD, p, r1, k, unres, next_thresh):
        """x2-doubling passes over a compact (p, r1) buffer until every
        lane's unresolved count drops to next_thresh (or all resolved /
        k >= N).  One neighbour gather + one writeback per pass, both
        touching only the unresolved set."""
        C = p.shape[1]
        jc = jnp.arange(C, dtype=jnp.int32)[None, :]

        def cond(state):
            _, _, _, _, k, unres = state
            return jnp.logical_and(k < N, jnp.any(unres > next_thresh))

        def body(state):
            rankD, p, r1, unresolved, k, _ = state
            live = p >= 0
            q = jnp.where(live, jnp.remainder(p + k, nn), N)
            r1m = jnp.where(live, r1, INF)
            n1m = jnp.where(live, jnp.take_along_axis(rankD, q, axis=1), INF)
            r1s, n1s, ps = lax.sort((r1m, n1m, jnp.where(live, p, -1)),
                                    dimension=1, is_stable=False, num_keys=2)
            lives = r1s != INF
            changed_seg = jnp.concatenate(
                [jnp.ones((B, 1), bool), r1s[:, 1:] != r1s[:, :-1]], axis=1)
            changed_sub = changed_seg
            for c in (r1s, n1s):
                changed_sub = changed_sub | jnp.concatenate(
                    [jnp.ones((B, 1), bool), c[:, 1:] != c[:, :-1]], axis=1)
            seg_start = lax.cummax(jnp.where(changed_seg, jc, 0), axis=1)
            sub_start = lax.cummax(jnp.where(changed_sub, jc, 0), axis=1)
            new_r1 = jnp.where(lives, r1s + (sub_start - seg_start), INF)
            nxt = jnp.concatenate(
                [changed_sub[:, 1:], jnp.ones((B, 1), bool)], axis=1)
            unresolved = jnp.logical_not(changed_sub & nxt) & lives
            rankD = rankD.at[br, jnp.where(lives, ps, N)].set(
                jnp.where(lives, new_r1, N))
            unres = jnp.sum(unresolved.astype(jnp.int32), axis=1)
            return rankD, ps, new_r1, unresolved, k * 2, unres

        # at stage entry every live buffer entry is (still) unresolved
        unres0 = p >= 0
        return lax.while_loop(cond, body, (rankD, p, r1, unres0, k, unres))

    for cap in ladder[1:] + [0]:
        rankD, p_buf, r_buf, unres_f, k, unres = tail_stage(
            rankD, p_buf, r_buf, k, unres, cap)
        if cap:
            p_buf, r_buf = _compact_by_sort(
                jnp.where(unres_f, p_buf, INF), r_buf, cap)
    rank = rankD[:, :N]

    # ---------------- final order + last column + origPtr ----------------
    # prev-byte plane: pb[i] = block[(i-1) mod n]
    lastb = jnp.take_along_axis(bi, jnp.maximum(n - 1, 0)[:, None], axis=1)
    pb = jnp.where(idx == 0, lastb, jnp.roll(bx, 1, axis=1)[:, :N])
    # final keys are all-distinct (converged ranks on valid positions,
    # N+idx on pads), so one unstable 1-key reorder is deterministic.
    rk = jnp.where(valid, rank, N + idx)
    _, sa, pbs = lax.sort((rk, idx_b, pb), dimension=1, is_stable=False,
                          num_keys=1)
    last = jnp.where(valid, pbs, 0).astype(jnp.uint8)

    # origPtr tie policy (see oracle.bwt): last in-class slot =
    # |{i : rot_i <= rot_0}| - 1 (rotation 0's rank when rotations are
    # distinct; class base + m - 1 on exactly-periodic blocks).
    r0 = rank[:, 0]
    orig_ptr = jnp.sum(jnp.where(valid & (rank <= r0[:, None]), 1, 0),
                       axis=1) - 1
    return last, orig_ptr.astype(jnp.int32), sa
