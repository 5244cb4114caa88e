"""Device block decode: batched Huffman symbol decode, MTF^-1, RLE2
expansion and inverse BWT as XLA programs.

The reference decodes a block with one bit-serial coroutine
(decompress.c:476-664 symbol loop, :767-790 + bzlib_private.h:442-444
inverse BWT).  The batched formulation splits it into data-parallel stages:

* **Symbol decode** — the host light-scan (native bz2tpu_parse_block)
  provides each 50-symbol group's start bit offset, which removes the
  serial bit dependency ACROSS groups; every group then decodes its 50
  symbols in parallel lanes (B x G, with G bucketed to the batch's real
  group count).  Each symbol is one byte-granular 25-bit window gather
  plus one-or-two probes of device-built two-level canonical LUTs
  (huffman.c:180-236's tables generalized to a 12-bit direct window with
  a 20-bit-prefix escape level).
* **MTF^-1** — permutation-monoid chunking: the list update for rank r
  is a content-independent cycle on positions, so 512 chunks scan
  locally (U symbols unrolled per step) and one short sequential compose
  anchors every chunk to the initial list.
* **RLE2 expansion** — run lengths from the bijective-base-2 digits by
  segmented arithmetic (no scan), output offsets by prefix sum, and a
  scatter + running-max fill builds the BWT last column.
* **Inverse BWT** — successor array from one stable sort (the tt
  permutation, decompress.c:767-790) with the segment-end flag packed in,
  then a two-wave splitter walk: W1 walkers start at evenly spaced
  positions and chase the permutation concurrently, so the serial chain
  depth drops from n to ~n/W1; long-segment survivors compact 4:1 into a
  second wave; segments are reordered by rank and regathered.  Walkers
  that exceed the step budget (adversarially skewed cycles) flag the
  lane for the host fallback.

All shapes are static; corrupt input degrades to wrong bytes, never to
out-of-bounds access — the orchestrator (bzip2_tpu/decoder.py) validates
both CRC layers and falls back to the host decoder per block.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

MAX_GROUPS = 18002
G_SIZE = 50
MTF_UNROLL = 8


# --------------------------------------------------------------- tables ---

LUT_BITS = 12
#: 12-bit windows the >12-bit code region can span.  A Kraft-complete
#: table's long-code probability mass is at most 258 * 2^-13, i.e. at most
#: ceil(258/2) = 129 windows — 132 covers every table the native parse's
#: Kraft validation admits, so there is no fallback path.
ESC_PREFIXES = 132


def build_tables(lens, alpha):
    """Batched canonical decode LUTs, built ON DEVICE from code lengths
    (the only per-block table data the host transfers is lens itself,
    ~6 KB/block).

    lens (B, 6, A) i32 (unused tables all-zero); alpha (B,) i32.  Returns
    (lut1 (B,6,4096) i32, lut2 (B,6,ESC_PREFIXES*256) i32,
    esc_base (B,6) i32); entries are len | sym<<5, 0 = escape to lut2 (or
    invalid input).

    lut1 is a direct 12-bit-window lookup — the fan-out generalization of
    the reference's 8-bit fast-start table (huffman.c:170-236,
    bzlib_private.h:142).  Canonical allocation puts all >12-bit codes in
    one contiguous window suffix [esc_base, 4096), which lut2 resolves
    from the top 20 window bits (the format's range check caps code
    lengths at 20, decompress.c:411-423).  Construction is three
    scatter+cummax range fills over the canonical codes from
    assign_codes_lanes (huffman.c:152-166 semantics)."""
    from ..constants import MAX_ALPHA_SIZE as A
    from .huffman import assign_codes_lanes

    B = lens.shape[0]
    L = B * 6
    lensf = lens.reshape(L, A).astype(jnp.int32)
    alpha6 = jnp.repeat(alpha.astype(jnp.int32), 6)
    codes = assign_codes_lanes(lensf, alpha6)              # (L, A)
    sym = jnp.arange(A, dtype=jnp.int32)[None, :]
    active = sym < alpha6[:, None]
    payload = jnp.where(active, lensf | (sym << 5), 0)
    brl = jnp.arange(L, dtype=jnp.int32)[:, None]

    def range_fill(width, pos, val, extra_pos=None, extra_val=None):
        """Scatter (pos<<15 | val) marks, cummax, keep the low 15 bits.
        Marks carry their own position in the high bits so the running max
        resolves each window to the latest preceding range start."""
        buf = jnp.zeros((L, width + 1), jnp.int32).at[
            brl, jnp.where(val > 0, jnp.clip(pos, 0, width - 1), width)
        ].set(jnp.where(val > 0, (jnp.clip(pos, 0, width - 1) << 15) | val,
                        0))
        if extra_pos is not None:
            buf = buf.at[brl[:, 0], jnp.where(extra_pos < width, extra_pos,
                                              width)].set(extra_val)
        return lax.cummax(buf[:, :width], axis=1) & 0x7FFF

    short = active & (lensf >= 1) & (lensf <= LUT_BITS)
    start1 = jnp.where(short, codes << jnp.clip(LUT_BITS - lensf, 0, 12), 0)
    # escape base = total window span of short codes (complete tables
    # cover [0, ebase) exactly)
    ebase = jnp.sum(
        jnp.where(short, 1 << jnp.clip(LUT_BITS - lensf, 0, 12), 0), axis=1)
    lut1 = range_fill(1 << LUT_BITS, start1, jnp.where(short, payload, 0),
                      extra_pos=ebase, extra_val=ebase << 15)

    longm = active & (lensf > LUT_BITS)
    start2 = jnp.where(
        longm, (codes << jnp.clip(20 - lensf, 0, 8)) - (ebase[:, None] << 8),
        0)
    lut2 = range_fill(ESC_PREFIXES << 8, start2,
                      jnp.where(longm & (start2 >= 0), payload, 0))
    return (lut1.reshape(B, 6, 1 << LUT_BITS),
            lut2.reshape(B, 6, ESC_PREFIXES << 8),
            ebase.reshape(B, 6))


# -------------------------------------------------------- symbol decode ---

def _symbol_scan(wb8, goff, gsel, gvalid, lut1, lut2, esc_base, take_w):
    """Shared 50-step symbol scan; ``take_w(wb8, wi)`` reads the 32-bit
    window at byte index wi (flat- or row-addressed)."""
    B, G = goff.shape
    lut1f = lut1.reshape(B, 6 << LUT_BITS)
    lut2f = lut2.reshape(B, 6 * (ESC_PREFIXES << 8))
    # per-lane escape base via 6-way select (tiny)
    ebase = jnp.zeros((B, G), jnp.int32)
    for t in range(6):
        ebase = jnp.where(gsel == t, esc_base[:, t][:, None], ebase)

    def step(off, _):
        wi = off >> 3
        sh = (off & 7).astype(jnp.uint32)
        w = take_w(wb8, wi) << sh
        w12 = (w >> (32 - LUT_BITS)).astype(jnp.int32)
        e1 = jnp.take_along_axis(lut1f, (gsel << LUT_BITS) + w12, axis=1)
        loc2 = ((w >> 12).astype(jnp.int32) - (ebase << 8))
        idx2 = gsel * (ESC_PREFIXES << 8) + jnp.clip(
            loc2, 0, (ESC_PREFIXES << 8) - 1)
        e2 = jnp.take_along_axis(lut2f, idx2, axis=1)
        entry = jnp.where(e1 > 0, e1, e2)
        length = entry & 31
        off2 = off + jnp.where(gvalid, length, 0)
        return off2, (entry >> 5).astype(jnp.int16)

    _, syms = lax.scan(step, goff, None, length=G_SIZE)    # (50, B, G)
    return jnp.transpose(syms, (1, 2, 0)).reshape(B, G * G_SIZE
                                                  ).astype(jnp.int32)


def _byte_windows(words):
    """(..., WT) u32 words -> (..., 4*WT) u32: wb8[i] is the 32-bit
    big-endian window starting at byte i.  One such gather yields >= 25
    valid bits after the (off & 7) shift, and every code is <= 20 bits
    (decompress.c:411-423 range check), so a single read per symbol
    suffices.  Built once from four byte-plane rolls."""
    b0 = words >> 24
    b1 = (words >> 16) & 0xFF
    b2 = (words >> 8) & 0xFF
    b3 = words & 0xFF
    byts = jnp.stack([b0, b1, b2, b3], axis=-1).reshape(
        words.shape[:-1] + (4 * words.shape[-1],))
    return ((byts << 24) | (jnp.roll(byts, -1, axis=-1) << 16)
            | (jnp.roll(byts, -2, axis=-1) << 8)
            | jnp.roll(byts, -3, axis=-1))


def decode_symbols(words, goff, gsel, gvalid, lut1, lut2, esc_base):
    """words: flat (WT,) u32 big-endian bit buffer shared by the whole
    batch; goff (B,G) i32 absolute bit offsets into it; gsel (B,G) i32;
    gvalid (B,G) bool; lut1/lut2/esc_base from build_tables, batched
    (B, ...).  Returns syms (B, G*50) i32 in stream order (garbage in
    invalid lanes).

    Each group decodes its 50 symbols serially (the in-group bit chain),
    all B*G groups in parallel; a symbol costs three (B,G) gathers — one
    byte-granular 25-bit window read plus the one-or-two-level LUT
    probes.  The stage is gather-throughput-bound, so the gather count
    per symbol IS the cost model."""
    WT = words.shape[0]
    wb8 = _byte_windows(words)

    def take_flat(wb, wi):
        return jnp.take(wb, jnp.clip(wi, 0, 4 * WT - 1), mode="clip")

    return _symbol_scan(wb8, goff, gsel, gvalid, lut1, lut2, esc_base,
                        take_flat)


def decode_symbols_rows(words, goff, gsel, gvalid, lut1, lut2, esc_base):
    """Row-addressed variant for the sharded (mesh) path: words (B, WT)
    u32 per-block rows, goff (B,G) bit offsets local to each row.  Every
    array is batched on the block axis, so the program partitions cleanly
    under sharding annotations (no flat shared buffer to rebase)."""
    B, WT = words.shape
    wb8 = _byte_windows(words)                             # (B, 4*WT)

    def take_rows(wb, wi):
        return jnp.take_along_axis(wb, jnp.clip(wi, 0, 4 * WT - 1), axis=1)

    return _symbol_scan(wb8, goff, gsel, gvalid, lut1, lut2, esc_base,
                        take_rows)


# ---------------------------------------------------------------- MTF^-1 ---

MTF_CHUNKS = 512


def mtf_inverse(syms, used_list, n_used, n_mtf, n_chunks: int = MTF_CHUNKS):
    """syms (B,M) i32; used_list (B,256) i32 initial MTF list (padded 0);
    n_used/n_mtf (B,) i32.  Returns vals (B,M) i32: the decoded byte per
    symbol (for RUNA/RUNB, the byte the zero-run repeats).

    Chunked permutation-monoid formulation: the MTF list update for a
    decoded rank r is the fixed cycle (0 1 .. r) on *positions* — it does
    not depend on the list contents — so the list after any prefix is the
    initial list gathered through a composed permutation.  M splits into
    ``n_chunks`` chunks processed concurrently: a short local scan per
    chunk computes each symbol's index into the chunk-start list plus the
    chunk's net permutation; a cheap sequential compose over chunk
    summaries (n_chunks steps of a (B,256) gather) then anchors every
    chunk to the true initial list.  Turns the reference's strictly
    sequential hot loop (decompress.c:476-664) into ~M/n_chunks-deep
    data-parallel work."""
    B, M = syms.shape
    C = n_chunks
    U = MTF_UNROLL
    K = -(-(-(-M // C)) // U) * U                         # chunk len, pad U
    Mp = C * K
    syms_p = jnp.pad(syms, ((0, 0), (0, Mp - M)),
                     constant_values=10_000)               # no-op symbols
    xs = syms_p.reshape(B, C, K // U, U).transpose(2, 0, 1, 3)
    j256 = jnp.arange(256, dtype=jnp.int32)
    lst0 = jnp.broadcast_to(j256, (B, C, 256)).astype(jnp.int32)
    nu = n_used[:, None]

    def one(lst, s):
        r = jnp.clip(s - 1, 0, 255)
        v = jnp.take_along_axis(lst, r[:, :, None], axis=2)[:, :, 0]
        e = jnp.where(s <= 1, lst[:, :, 0], v)
        upd = (s >= 2) & (s <= nu)
        shifted = jnp.concatenate([v[:, :, None], lst[:, :, :-1]], axis=2)
        lst = jnp.where(upd[:, :, None] & (j256 <= r[:, :, None]),
                        shifted, lst)
        return lst, e

    def step(lst, su):
        es = []
        for u in range(U):
            lst, e = one(lst, su[:, :, u])
            es.append(e)
        return lst, jnp.stack(es, axis=2)                  # (B, C, U)

    P, es = lax.scan(step, lst0, xs)      # P (B,C,256): chunk permutations
    e = jnp.transpose(es, (1, 2, 0, 3)).reshape(B, C, K)

    # Sequential exclusive compose over chunk summaries:
    # S_{c+1} = S_c[P_c]; anchor to values F_c = L0[S_c] as we go.
    def comp(S, Pc):
        return jnp.take_along_axis(S, Pc, axis=1), S

    _, S_all = lax.scan(comp,
                        jnp.broadcast_to(j256, (B, 256)).astype(jnp.int32),
                        jnp.transpose(P, (1, 0, 2)))
    S_all = jnp.transpose(S_all, (1, 0, 2))                # (B,C,256) excl.
    F = jnp.take_along_axis(
        jnp.broadcast_to(used_list[:, None, :], (B, C, 256)), S_all, axis=2)
    out = jnp.take_along_axis(
        F.reshape(B, C * 256),
        (jnp.arange(C, dtype=jnp.int32)[None, :, None] * 256
         + jnp.clip(e, 0, 255)).reshape(B, Mp), axis=1)
    return out[:, :M]


# ------------------------------------------------- RLE2 + BWT last column ---

def rle2_expand(syms, vals, n_used, n_mtf, N):
    """Build the BWT last column: syms/vals (B,M); returns
    (last (B,N) i32 with 0 padding, n_out (B,) i32)."""
    B, M = syms.shape
    idx = jnp.arange(M, dtype=jnp.int32)[None, :]
    valid = idx < n_mtf[:, None]
    isz = (syms <= 1) & valid
    seg_start = isz & jnp.concatenate(
        [jnp.ones((B, 1), bool), ~isz[:, :-1]], axis=1)
    run_base = lax.cummax(jnp.where(seg_start, idx, 0), axis=1)
    k = jnp.clip(idx - run_base, 0, 30)
    cnt = jnp.where(isz, (syms + 1) << k,
                    jnp.where(valid & (syms >= 2)
                              & (syms <= n_used[:, None]), 1, 0))
    offs = jnp.cumsum(cnt, axis=1) - cnt                   # exclusive
    n_out = jnp.sum(cnt, axis=1)
    emit = cnt > 0
    packed = jnp.where(emit, ((idx + 1) << 8) | (vals & 0xFF), 0)
    br = jnp.arange(B, dtype=jnp.int32)[:, None]
    tgt = jnp.where(emit, jnp.clip(offs, 0, N - 1), N)
    blk = jnp.zeros((B, N + 1), jnp.int32).at[br, tgt].set(packed)[:, :N]
    filled = lax.cummax(blk, axis=1)
    return filled & 0xFF, n_out


# ----------------------------------------------------------- inverse BWT ---


def ibwt(last, n_out, orig_ptr, n_walkers: int = 4096, budget: int = 32):
    """last (B,N) i32; n_out (B,); orig_ptr (B,).  Returns
    (out (B,N) i32 decoded post-RLE1 bytes, ok (B,) bool — False when a
    lane exceeded the total step budget and needs the host fallback).

    Successor array from one stable sort, packed with the emitted char
    AND a segment-end flag as ``tt = A<<9 | is_splitter(A)<<8 | last`` so
    the walk costs ONE gather and no divisions per step (the reference's
    tt composition, decompress.c:767-790; the flag replaces the per-step
    closed-form splitter inversion of the round-4 design — walkers record
    the hit POSITION and the ids are recovered once per wave).  W1-1
    evenly spaced splitter positions plus the true start seq_0 =
    A[orig_ptr] (walker W1-1) cut the permutation cycle into segments.

    Wave 1 walks all W1 lanes under an early-exiting while_loop capped at
    2x the mean segment length; surviving long segments (expected
    W1*e^-2) compact into W1/4 lanes and continue under the remaining
    budget, again exiting as soon as every lane finishes — so the wall
    tracks the actual maximum segment length (~mean*ln W1), not the
    worst-case budget.  Segment ranks come from pointer jumping over the
    walker-successor graph (log W1 rounds); assembly is one scatter of
    segment-start marks + running max + one flat gather across both wave
    buffers.  A lane flags ``ok`` False only when the budget (default
    32x mean) is exhausted or wave-2 lanes overflow — probability ~e^-30
    per segment on any input without adversarial cycle structure, and
    still merely a correctness-preserving host heal when it fires."""
    B, N = last.shape
    W1 = n_walkers
    assert W1 <= 4096 and N <= (1 << 20), "tt packing: 20b succ + flag + 8b"
    W2 = max(W1 // 4, 8)
    S = W1 - 1                                  # regular splitter count
    br = jnp.arange(B, dtype=jnp.int32)[:, None]
    idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    n = jnp.maximum(n_out, 1)[:, None]                     # (B,1)

    key = jnp.where(idx < n, last, 1 << 20)
    _, A = lax.sort((key, jnp.broadcast_to(idx, (B, N))), dimension=1,
                    is_stable=True, num_keys=1)            # successor map

    start_pos = jnp.take_along_axis(A, orig_ptr[:, None], axis=1)  # (B,1)

    # splitters p_j = floor(j*n/S) for j < S, deduplicated when n < S and
    # against the forced seq_0 splitter (walker S).  j*n would overflow
    # i32 at W1 = 4096, so the quotient splits exactly:
    # floor(j*n/S) = j*(n//S) + floor(j*(n mod S)/S).
    j_s = jnp.arange(W1, dtype=jnp.int32)[None, :]
    j_reg = j_s[:, :S]
    p_reg = j_reg * (n // S) + (j_reg * (n % S)) // S
    p_j = jnp.concatenate([p_reg, start_pos], axis=1)      # (B, W1)
    w_valid = jnp.concatenate(
        [jnp.ones((B, 1), bool), p_reg[:, 1:] != p_reg[:, :-1],
         jnp.ones((B, 1), bool)], axis=1)
    w_valid = w_valid & ((j_s == S) | (p_j != start_pos))

    # splitter-id map: walker id + 1 scattered at each (valid) segment
    # start — one unique-index scatter replaces the round-4 per-step
    # closed-form inversion (whose q*S product would also overflow here)
    smap = jnp.zeros((B, N + 1), jnp.int32).at[
        br, jnp.where(w_valid, jnp.clip(p_j, 0, N - 1), N)].set(
        jnp.where(w_valid, j_s + 1, 0))[:, :N]

    def splitter_id(q):
        """Walker id whose segment starts at position q, or -1."""
        return jnp.take_along_axis(smap, q, axis=1) - 1

    tt = (A << 9) \
        | ((jnp.take_along_axis(smap, A, axis=1) > 0).astype(jnp.int32) << 8) \
        | jnp.where(idx < n, last & 0xFF, 0)

    m = N // S + 1                                         # mean seg len
    cap1 = 2 * m
    cap2 = max((budget - 2) * m, 1)
    # assembly marks are (offset<<11 | payload): lane ids > 11 bits ship
    # their two high bits in the c1 fill's spare bits (so cap1 must fit 9)
    assert cap1 <= 0x1FF and W2 <= 0x7FF, "assembly mark packing"

    def wave(cur0, W, cap):
        """Walk W lanes until every segment ends or ``cap`` steps pass;
        the while_loop exits as soon as all lanes are done, so quiet
        waves cost actual-steps, not cap.  Records the hit position;
        callers recover the splitter id once per wave."""
        buf0 = jnp.zeros((B, W, cap), jnp.uint8)

        def cond(st):
            cur, _, _, _, t = st
            return (t < cap) & jnp.any(cur >= 0)

        def body(st):
            cur, cnt, hitp, buf, t = st
            active = cur >= 0
            cc = jnp.clip(cur, 0, N - 1)
            v = jnp.take_along_axis(tt, cc, axis=1)
            nxt = v >> 9
            done = active & ((v & 0x100) != 0)
            hitp = jnp.where(done, nxt, hitp)
            cnt = cnt + active.astype(jnp.int32)
            cur = jnp.where(active & ~done, nxt, -1)
            buf = lax.dynamic_update_slice(
                buf, jnp.where(active, v & 0xFF, 0
                               ).astype(jnp.uint8)[:, :, None], (0, 0, t))
            return cur, cnt, hitp, buf, t + 1

        cur, cnt, hitp, buf, _ = lax.while_loop(
            cond, body, (cur0, jnp.zeros((B, W), jnp.int32),
                         jnp.full((B, W), -1, jnp.int32), buf0, jnp.int32(0)))
        hitj = jnp.where(hitp >= 0, splitter_id(jnp.clip(hitp, 0, N - 1)), -1)
        return cur, cnt, hitj, buf

    cur0 = jnp.where(w_valid, p_j, -1)
    cur1, cnt1, hitj1, buf1 = wave(cur0, W1, cap1)

    # compact the rare survivors (long segments) into W2 lanes
    surv = cur1 >= 0
    dest = jnp.cumsum(surv.astype(jnp.int32), axis=1) - 1
    over = jnp.any(surv & (dest >= W2), axis=1)
    slot = jnp.where(surv & (dest < W2), dest, W2)
    cur2in = jnp.full((B, W2 + 1), -1, jnp.int32).at[br, slot].set(
        jnp.where(surv, cur1, -1))[:, :W2]
    src_id = jnp.full((B, W2 + 1), -1, jnp.int32).at[br, slot].set(
        jnp.where(surv, j_s, -1))[:, :W2]
    cur2, cnt2c, hitj2c, buf2 = wave(cur2in, W2, cap2)
    ok = ~(jnp.any(cur2 >= 0, axis=1) | over)

    # merge wave-2 results back onto their originating walkers
    src_c = jnp.clip(src_id, 0, W1 - 1)
    src_t = jnp.where(src_id >= 0, src_c, W1)
    add_cnt = jnp.zeros((B, W1 + 1), jnp.int32).at[br, src_t].set(
        cnt2c)[:, :W1]
    fix_hit = jnp.full((B, W1 + 1), -1, jnp.int32).at[br, src_t].set(
        hitj2c)[:, :W1]
    cnt = cnt1 + add_cnt
    hitj = jnp.where(hitj1 >= 0, hitj1, fix_hit)
    hitj = jnp.where(w_valid, hitj, -1)

    # segment ranks by pointer jumping over the walker chain: hitj is the
    # successor walker; seq_0 (walker S) is rank 0 and the zero-distance
    # terminal, so unconditional jumping yields distance-to-seq_0 in
    # log2(W1) rounds and rank = (live_count - dist) mod live_count.
    live = w_valid & (cnt > 0)
    terminal = (~live) | (j_s == S)
    ptr = jnp.where(terminal, j_s, jnp.clip(hitj, 0, W1 - 1))
    dist = jnp.where(terminal, 0, 1)
    for _ in range(max(W1.bit_length(), 1)):
        dist = dist + jnp.take_along_axis(dist, ptr, axis=1)
        ptr = jnp.take_along_axis(ptr, ptr, axis=1)
    total = jnp.sum(live.astype(jnp.int32), axis=1)[:, None]
    rank = jnp.where(live, (total - dist) % jnp.maximum(total, 1), W1)

    # per-walker output offsets: scatter cnt by rank, exclusive cumsum,
    # gather back
    cnt_by_rank = jnp.zeros((B, W1 + 1), jnp.int32).at[
        br, jnp.clip(rank, 0, W1)].set(jnp.where(live, cnt, 0))[:, :W1]
    off_by_rank = jnp.cumsum(cnt_by_rank, axis=1) - cnt_by_rank
    goffw = jnp.take_along_axis(
        jnp.concatenate([off_by_rank, jnp.zeros((B, 1), jnp.int32)], axis=1),
        jnp.clip(rank, 0, W1), axis=1)

    # assemble: every per-position walker attribute arrives by scattering
    # (goffw<<11 | payload) marks at segment starts and cummax-filling —
    # the offset in the top bits makes the LATEST segment start win, and
    # three cheap cummax scans replace three (B,N) random gathers.  The
    # single remaining gather pulls the chars from the concatenated wave
    # buffers.
    cap1_s, cap2_s = buf1.shape[2], buf2.shape[2]
    goc = jnp.clip(goffw, 0, N - 1) << 11

    def fill(payload):
        mk = jnp.zeros((B, N + 1), jnp.int32).at[
            br, jnp.where(live, jnp.clip(goffw, 0, N - 1), N)
        ].set(jnp.where(live, goc | payload, 0))[:, :N]
        return lax.cummax(mk, axis=1)

    f_lane = fill((j_s + 1) & 0x7FF)
    pos_in = idx - (f_lane >> 11)
    # c1 fill: 9 bits of wave-1 count + the lane id's two high bits
    fc1 = fill((((j_s + 1) >> 11) << 9) | jnp.minimum(cnt1, 0x1FF))
    lane_c = jnp.clip((((fc1 >> 9) & 3) << 11) | (f_lane & 0x7FF), 1,
                      W1) - 1                              # walker per pos
    c1 = fc1 & 0x1FF                                       # cap1 < 512
    # wave-2 lane of each walker (W2 when it had none)
    w2lane = jnp.full((B, W1 + 1), W2, jnp.int32).at[br, src_t].set(
        jnp.arange(W2, dtype=jnp.int32)[None, :])[:, :W1]
    l2 = fill(w2lane) & 0x7FF
    in1 = pos_in < c1
    flat = jnp.concatenate(
        [buf1.reshape(B, W1 * cap1_s), buf2.reshape(B, W2 * cap2_s)], axis=1)
    g = jnp.where(in1, lane_c * cap1_s + jnp.clip(pos_in, 0, cap1_s - 1),
                  W1 * cap1_s + jnp.clip(l2, 0, W2 - 1) * cap2_s
                  + jnp.clip(pos_in - c1, 0, cap2_s - 1))
    out = jnp.take_along_axis(flat, g, axis=1).astype(jnp.int32)
    return out, ok


# ----------------------------------------------------- RLE1^-1 + CRC-32 ---

CRC_POLY = 0x04C11DB7


def _crc_constants():
    """Host constants: F (8,) basis columns folded to 32 u32 (byte-feed
    update as xor of 8 basis vectors) and the 32 squaring matrices for
    x^(8*2^k) (each (32,) u32 rows)."""
    # basis: contribution of input byte bit k to the next CRC state
    basis = np.zeros(8, np.uint32)
    for k in range(8):
        c = np.uint32(1 << k) << 24
        for _ in range(8):
            c = np.uint32((c << 1) ^ CRC_POLY) if c & 0x80000000 else np.uint32(c << 1)
        basis[k] = c
    # shift-by-one-byte matrix M8: state -> state * x^8 mod poly
    def mat_shift8():
        M = np.zeros(32, np.uint32)          # M[i] = image of basis vector i
        for i in range(32):
            c = np.uint32(1 << i)
            for _ in range(8):
                c = np.uint32((c << 1) ^ CRC_POLY) if c & 0x80000000 else np.uint32(c << 1)
            M[i] = c
        return M

    def mat_mul(A, Bm):
        out = np.zeros(32, np.uint32)
        for i in range(32):
            v = A[i]
            r = np.uint32(0)
            for b in range(32):
                if (v >> b) & 1:
                    r ^= Bm[b]
            out[i] = r
        return out

    mats = [mat_shift8()]
    for _ in range(31):
        mats.append(mat_mul(mats[-1], mats[-1]))
    return basis, np.stack(mats)             # (8,), (32, 32)


_CRC_BASIS, _CRC_POW = _crc_constants()


def _mat_apply(vec, mat_rows):
    """vec (...,) u32 state; mat_rows (32,) u32: out = xor of rows where
    vec bit set."""
    out = jnp.zeros_like(vec)
    for b in range(32):
        out = out ^ jnp.where((vec >> b) & 1 != 0, jnp.uint32(mat_rows[b]),
                              jnp.uint32(0))
    return out


def crc32_device(data, lengths, n_lanes: int = 512):
    """CRC-32/BZIP2 of each row of ``data`` (B, N) u8/i32, over
    ``lengths`` (B,) bytes — computed as a GF(2)-linear fold: per-lane
    partial CRCs (table-free byte feed: 8 basis xors per byte) combined
    with x^(8k) matrix powers.  Returns (B,) uint32."""
    B, N = data.shape
    C = n_lanes
    Lc = -(-N // C)
    NT = C * Lc
    # right-align the message (leading zeros are free for a zero-init CRC
    # fold, trailing zeros are not), so every lane's shift is its static
    # suffix (C-1-i)*Lc
    idx = jnp.arange(NT, dtype=jnp.int32)[None, :]
    pad = NT - lengths[:, None]
    src = jnp.clip(idx - pad, 0, N - 1)
    x = jnp.where(idx >= pad,
                  jnp.take_along_axis(data.astype(jnp.int32) & 0xFF, src,
                                      axis=1), 0).astype(jnp.uint32)
    xs = jnp.transpose(x.reshape(B, C, Lc), (2, 0, 1))    # (Lc, B, C)
    basis = [jnp.uint32(int(v)) for v in _CRC_BASIS]

    def step(crc, byte):
        t = (crc >> 24) ^ byte
        nxt = crc << 8
        for k in range(8):
            nxt = nxt ^ jnp.where((t >> k) & 1 != 0, basis[k], jnp.uint32(0))
        return nxt, None

    lane_crc, _ = lax.scan(step, jnp.zeros((B, C), jnp.uint32), xs)

    def shift_by(vec, k):
        # vec * x^(8k): apply the precomputed squaring matrices by k's bits
        out = vec
        for b in range(26):                  # 8k < 2^29 bits
            rows = _CRC_POW[b]
            out = jnp.where((k >> b) & 1 != 0, _mat_apply(out, rows), out)
        return out

    suffix = ((C - 1 - jnp.arange(C, dtype=jnp.int32)) * Lc)[None, :]
    shifted = shift_by(lane_crc, jnp.broadcast_to(
        suffix.astype(jnp.uint32), (B, C)))
    raw = lax.reduce(shifted, jnp.uint32(0), lambda a, b: a ^ b, (1,))
    init = shift_by(jnp.full((B,), 0xFFFFFFFF, jnp.uint32),
                    lengths.astype(jnp.uint32))
    return ~(raw ^ init)


def rle1_inverse(x, n, NOUT: int):
    """Invert the RLE1 pre-pass: x (B,N) i32 post-RLE1 bytes, n (B,)
    lengths.  Returns (out (B,NOUT) i32, out_len (B,) i32, fits (B,) bool).

    A count byte is either the 5th byte of a 4-byte equal group or the
    first byte of a maximal equal run whose predecessor run left the
    parser count-pending; the 2-state parser FSM over maximal runs is
    composed with an associative scan, everything else is arithmetic
    (reference semantics: unRLE_obuf_to_output_FAST, bzlib.c:531-677)."""
    B, N = x.shape
    idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    valid = idx < n[:, None]
    xb = jnp.where(valid, x & 0xFF, -1)
    prev = jnp.concatenate([jnp.full((B, 1), -2, jnp.int32), xb[:, :-1]],
                           axis=1)
    start = (xb != prev) & valid                           # run starts
    rs = lax.cummax(jnp.where(start, idx, 0), axis=1)      # run start pos
    r = idx - rs

    # run lengths at start positions: next start's index - this start's
    nxt_start_pos = jnp.flip(
        lax.cummin(jnp.flip(jnp.where(start, idx, 1 << 30), axis=1), axis=1),
        axis=1)
    # position of the next run start strictly after idx
    after = jnp.concatenate(
        [nxt_start_pos[:, 1:], jnp.full((B, 1), 1 << 30, jnp.int32)], axis=1)
    run_end = jnp.minimum(after, n[:, None])               # exclusive
    run_len = jnp.where(start, run_end - idx, 0)

    # 2-state FSM over runs: pending' = ((L - pending) % 5 == 4).  Only
    # three transitions exist — flip (L%5==4), identity ((L-1)%5==4) and
    # reset-to-clean (everything else) — so the prefix composition is
    # "parity of flips since the last reset", plain cumsums + one gather
    # (an associative_scan with a custom combine compiles pathologically
    # on this backend).
    flip = start & ((run_len % 5) == 4)
    reset = start & ((run_len % 5) != 4) & (((run_len - 1) % 5) != 4)
    flips_at = jnp.cumsum(flip.astype(jnp.int32), axis=1)  # inclusive
    flips_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), flips_at[:, :-1]], axis=1)
    reset_pos = lax.cummax(jnp.where(reset, idx, -1), axis=1)
    reset_prev = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), reset_pos[:, :-1]], axis=1)
    flips_at_reset = jnp.where(
        reset_prev >= 0,
        jnp.take_along_axis(flips_at, jnp.clip(reset_prev, 0, N - 1),
                            axis=1), 0)
    pending_start = (flips_prev - flips_at_reset) & 1      # at run starts
    pending_here = jnp.take_along_axis(pending_start, rs, axis=1)

    eff = r - pending_here
    is_cnt = valid & ((pending_here == 1) & (r == 0)
                      | ((eff >= 0) & (eff % 5 == 4)))
    emit = jnp.where(valid, jnp.where(is_cnt, xb, 1), 0)
    val = jnp.where(is_cnt, prev, xb)
    offs = jnp.cumsum(emit, axis=1) - emit
    out_len = jnp.sum(emit, axis=1)
    fits = out_len <= NOUT

    br = jnp.arange(B, dtype=jnp.int32)[:, None]
    do = (emit > 0) & fits[:, None]
    packed = jnp.where(do, ((idx + 1) << 8) | val, 0)
    tgt = jnp.where(do, jnp.clip(offs, 0, NOUT - 1), NOUT)
    out = jnp.zeros((B, NOUT + 1), jnp.int32).at[br, tgt].set(packed)[:, :NOUT]
    filled = lax.cummax(out, axis=1)
    covered = jnp.arange(NOUT, dtype=jnp.int32)[None, :] < out_len[:, None]
    return jnp.where(covered, filled & 0xFF, 0), out_len, fits
