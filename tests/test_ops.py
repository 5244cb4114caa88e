"""JAX ops vs the NumPy oracle, element for element (CPU backend)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from bzip2_tpu.ops.bwt import bwt_batched
from bzip2_tpu.ops.huffman import assign_codes_lanes, make_code_lengths_lanes
from bzip2_tpu.ops.mtf import mtf_rle2_batched
from bzip2_tpu.oracle.bwt import bwt as obwt
from bzip2_tpu.oracle.huffman import assign_codes, make_code_lengths
from bzip2_tpu.oracle.mtf import mtf_rle2_encode


@pytest.fixture(scope="module")
def jitted():
    return {
        "bwt": jax.jit(bwt_batched),
        "mtf": jax.jit(lambda l, n, u: mtf_rle2_batched(l, n, u, tile=128)),
        "hlens": jax.jit(make_code_lengths_lanes),
        "hcodes": jax.jit(assign_codes_lanes),
    }


def _random_blocks(rng, B, N):
    blocks = np.zeros((B, N), np.uint8)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    for b in range(B):
        kind = rng.integers(0, 3)
        if kind == 0:
            blocks[b, :ns[b]] = rng.integers(0, 256, ns[b])
        elif kind == 1:
            blocks[b, :ns[b]] = rng.integers(97, 100, ns[b])
        else:
            p = int(rng.integers(1, 6))
            ns[b] = max((ns[b] // p) * p, p)
            blocks[b, :ns[b]] = np.tile(rng.integers(97, 100, p), N // p + 1)[:ns[b]]
    return blocks, ns


def test_bwt_batched_vs_oracle(jitted, rng):
    B, N = 3, 256
    for _ in range(8):
        blocks, ns = _random_blocks(rng, B, N)
        last, optr, _ = map(np.array, jitted["bwt"](jnp.array(blocks), jnp.array(ns)))
        for b in range(B):
            el, eo = obwt(blocks[b, :ns[b]])
            assert np.array_equal(last[b, :ns[b]], el)
            assert optr[b] == eo
            assert np.all(last[b, ns[b]:] == 0)


def test_mtf_batched_vs_oracle(jitted, rng):
    B, N = 3, 512
    for _ in range(8):
        last = np.zeros((B, N), np.uint8)
        ns = rng.integers(1, N + 1, B).astype(np.int32)
        uses = np.zeros((B, 256), bool)
        for b in range(B):
            k = int(rng.integers(1, 7))
            vals = np.sort(rng.choice(256, k, replace=False))
            seq = vals[rng.integers(0, k, ns[b])]
            if rng.integers(0, 2):
                seq = np.sort(seq)  # long zero-runs
            last[b, :ns[b]] = seq
            uses[b, np.unique(seq)] = True
        mtfv, n_mtf, niu = map(
            np.array, jitted["mtf"](jnp.array(last), jnp.array(ns), jnp.array(uses)))
        for b in range(B):
            emtfv, efreq, ek = mtf_rle2_encode(last[b, :ns[b]], uses[b])
            assert n_mtf[b] == emtfv.size
            assert np.array_equal(mtfv[b, :n_mtf[b]], emtfv.astype(np.int32))
            assert niu[b] == ek
            got_freq = np.bincount(mtfv[b, :n_mtf[b]], minlength=258)
            assert np.array_equal(got_freq, efreq)


def test_huffman_lanes_vs_oracle(jitted, rng):
    L = 12
    for kind in range(3):
        freqs = np.zeros((L, 258), np.int32)
        if kind == 2:  # in-domain skew: exercises the halve-retry path
            alphas = rng.integers(5, 25, L).astype(np.int32)
            for l in range(L):
                a = int(alphas[l])
                freqs[l, :a] = (2 ** np.minimum(np.arange(a), 19)).astype(np.int32)
        else:
            alphas = rng.integers(2, 259, L).astype(np.int32)
            for l in range(L):
                hi = 1000 if kind == 0 else 4  # kind 1: heavy ties
                freqs[l, :alphas[l]] = rng.integers(0, hi, alphas[l])
        lens = np.array(jitted["hlens"](jnp.array(freqs), jnp.array(alphas)))
        codes = np.array(jitted["hcodes"](jnp.array(lens), jnp.array(alphas)))
        for l in range(L):
            a = int(alphas[l])
            exp = make_code_lengths(freqs[l, :a], a)
            assert np.array_equal(lens[l, :a], exp), (kind, l)
            assert np.array_equal(codes[l, :a], assign_codes(exp, a)), (kind, l)


@pytest.mark.parametrize("slack", [16, 32, 64])
def test_bwt_batched_power_of_two_slack(jitted, rng, slack):
    """The longest block leaves exactly ``slack`` pad columns, so the
    doubling pass with k == slack reads the pad mirror's last slot (N-1),
    which shorter lanes also target: the mirror scatter must give that
    slot the kept lane's value whatever the backend's duplicate order."""
    N = 1024
    period = rng.integers(97, 123, 100).astype(np.uint8)   # ties past k=64
    blocks = np.zeros((3, N), np.uint8)
    ns = np.array([N - slack, N - slack - 37, 200], np.int32)
    blocks[0, :ns[0]] = np.tile(period, N // 100 + 1)[:ns[0]]
    blocks[1, :ns[1]] = rng.integers(97, 100, ns[1])
    blocks[2, :ns[2]] = rng.integers(0, 256, ns[2])
    last, optr, _ = jitted["bwt"](jnp.asarray(blocks), jnp.asarray(ns))
    last, optr = np.asarray(last), np.asarray(optr)
    for b in range(3):
        exp_last, exp_ptr = obwt(blocks[b, :ns[b]])
        assert np.array_equal(last[b, :ns[b]], exp_last), b
        assert optr[b] == exp_ptr, b


def test_group_hist_matches_numpy_count(rng):
    from bzip2_tpu.constants import G_SIZE, MAX_ALPHA_SIZE
    from bzip2_tpu.ops.groupsearch import build_group_hist
    B, M = 2, 1003
    mtfv = rng.integers(0, MAX_ALPHA_SIZE, (B, M)).astype(np.int32)
    n_mtf = np.array([M, 517], np.int32)
    got = np.asarray(build_group_hist(jnp.asarray(mtfv), jnp.asarray(n_mtf)))
    G = -(-M // G_SIZE)
    assert got.shape == (B, G, MAX_ALPHA_SIZE)
    for b in range(B):
        for g in range(G):
            seg = mtfv[b, g * G_SIZE: min((g + 1) * G_SIZE, n_mtf[b])]
            want = np.bincount(seg, minlength=MAX_ALPHA_SIZE)
            assert np.array_equal(got[b, g], want), (b, g)
