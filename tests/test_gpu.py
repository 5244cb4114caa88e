"""Card-only checks (``gpu`` marker): the device encode is bit-exact with
every block on the GPU, and the device decode round-trips at -1 and -9.
They skip where JAX's default backend is not a GPU; ``chip_smoke.py``
runs them on the card."""
import bz2 as stdlib_bz2

import pytest

pytestmark = pytest.mark.gpu


def _text(golden, n):
    return ((golden[1][0] + golden[2][0] + golden[3][0]) * 8)[:n]


@pytest.mark.parametrize("level", [1, 9])
def test_gpu_encode_all_blocks_on_device(gpu_device, golden, level):
    from bzip2_tpu import engine, rle1
    data = _text(golden, 2_030_000) + b"abcab" * 30_000
    n_blocks = len(rle1.encode_blocks(data, level))
    engine.reset_telemetry()
    out = engine.Engine(host_workers=0).compress(data, level)
    assert engine.SHARE["dev_blocks"] == n_blocks
    assert engine.SHARE["host_blocks"] == 0
    assert out == stdlib_bz2.compress(data, level)


@pytest.mark.parametrize("level", [1, 9])
def test_gpu_decode_roundtrip(gpu_device, golden, level):
    from bzip2_tpu import decoder
    data = _text(golden, 2_030_000)
    decoder.ANOMALIES.update({"lane": 0, "batch": 0})
    assert decoder.DeviceDecoder().decompress(
        stdlib_bz2.compress(data, level)) == data
    assert decoder.ANOMALIES == {"lane": 0, "batch": 0}


def test_gpu_mtf_kernel_matches_xla(gpu_device, rng):
    import jax.numpy as jnp
    import numpy as np

    from bzip2_tpu.ops.mtf import mtf_ranks_xla
    from bzip2_tpu.ops.mtf_gpu import mtf_ranks_gpu
    B, N = 4, 1 << 16
    seq = rng.integers(0, 256, (B, N)).astype(np.int32)
    seq[1] = np.sort(seq[1])
    ns = np.array([N, N - 1, 777, 1], np.int32)
    valid = np.arange(N)[None, :] < ns[:, None]
    seq = np.where(valid, seq, 0)
    want = np.asarray(mtf_ranks_xla(jnp.asarray(seq), jnp.asarray(valid)))
    got = np.asarray(mtf_ranks_gpu(jnp.asarray(seq), jnp.asarray(valid)))
    assert np.array_equal(np.where(valid, got, 0), np.where(valid, want, 0))
