"""The GPU MTF kernel (ops/mtf_gpu.py) against the XLA formulation, in
Pallas interpret mode on the CPU; the compiled kernel is checked on the
card by tests/test_gpu.py and chip_smoke.py."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bzip2_tpu.ops.mtf import mtf_ranks_xla  # noqa: E402
from bzip2_tpu.ops.mtf_gpu import mtf_ranks_gpu  # noqa: E402


def _case(kind, rng, B=2, N=1024):
    if kind == "random":
        seq = rng.integers(0, 256, (B, N))
        ns = np.array([N, 700])
    elif kind == "run_heavy":
        seq = np.sort(rng.integers(0, 12, (B, N)), axis=1)
        seq[1, ::97] = 200
        ns = np.array([N, N - 1])
    elif kind == "partial_tile":
        N = 1000                                  # not a multiple of TILE
        seq = rng.integers(0, 30, (B, N))
        ns = np.array([N, 65])
    else:                                         # one-symbol alphabet
        seq = np.full((B, N), 7)
        ns = np.array([N, 1])
    valid = np.arange(seq.shape[1])[None, :] < ns[:, None]
    return np.where(valid, seq, 0).astype(np.int32), valid


@pytest.mark.parametrize("kind", ["random", "run_heavy", "partial_tile",
                                  "one_symbol"])
def test_mtf_kernel_interpret_matches_xla(rng, kind):
    seq, valid = _case(kind, rng)
    N = seq.shape[1]
    want = np.asarray(mtf_ranks_xla(
        jnp.asarray(np.pad(seq, ((0, 0), (0, -N % 128)))),
        jnp.asarray(np.pad(valid, ((0, 0), (0, -N % 128)))), tile=128))[:, :N]
    got = np.asarray(mtf_ranks_gpu(jnp.asarray(seq), jnp.asarray(valid),
                                   interpret=True))
    assert got.shape == seq.shape
    assert np.array_equal(np.where(valid, got, 0), np.where(valid, want, 0))
