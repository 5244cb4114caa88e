"""Engine failure paths: device-batch errors propagate with no retry,
host-worker errors, host-only mode edge cases."""
import bz2 as stdlib_bz2

import pytest

pytest.importorskip("jax")
import jax  # noqa: E402

from bzip2_tpu import engine  # noqa: E402
from bzip2_tpu.engine import Engine  # noqa: E402


def test_device_batch_error_propagates_without_retry(monkeypatch, rng):
    """A device batch failing at run time reaches the caller as is: no
    retry, no recompile on another path, no host fallback."""
    eng = Engine(batch_size=2, host_workers=0, pipeline=1)
    calls = {"n": 0}

    def failing(self, level, arr, ns, uses, crcs):
        calls["n"] += 1
        raise jax.errors.JaxRuntimeError("INTERNAL: injected device failure")

    monkeypatch.setattr(Engine, "_encode_batch", failing)
    data = rng.integers(0, 256, 450_000, dtype="uint8").tobytes()
    with pytest.raises(jax.errors.JaxRuntimeError, match="injected"):
        eng.compress(data, 1)            # 5 blocks -> 3 batches
    assert calls["n"] == 1


def test_no_host_workers_encodes_every_block_on_device(rng):
    data = rng.integers(97, 110, 350_000, dtype="uint8").tobytes()
    engine.reset_telemetry()
    out = Engine(host_workers=0).compress(data, 1)
    assert out == stdlib_bz2.compress(data, 1)
    assert engine.SHARE["dev_blocks"] == 4      # 350 kB at -1
    assert engine.SHARE["host_blocks"] == 0


def test_host_worker_error_propagates(monkeypatch, rng):
    from bzip2_tpu import native
    if not native.available():
        pytest.skip("native runtime unavailable")
    eng = Engine(use_device=False)

    def boom(*a, **k):
        raise RuntimeError("injected native failure")

    monkeypatch.setattr(native, "encode_block", boom)
    data = rng.integers(97, 120, 150_000, dtype="uint8").tobytes()
    with pytest.raises(RuntimeError, match="injected native failure"):
        eng.compress(data, 1)


def test_host_only_mode_various_inputs(rng):
    from bzip2_tpu import native
    if not native.available():
        pytest.skip("native runtime unavailable")
    eng = Engine(use_device=False)
    for data in (b"", b"x", b"ab" * 300, b"z" * 100_000,
                 rng.integers(0, 256, 350_000, dtype="uint8").tobytes()):
        assert eng.compress(data, 1) == stdlib_bz2.compress(data, 1)


def test_host_only_requires_native(monkeypatch):
    from bzip2_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    eng = Engine(use_device=False)
    with pytest.raises(RuntimeError, match="native"):
        eng.compress(b"some data that makes a block", 1)
