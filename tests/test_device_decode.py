"""Device decode path (ops/decode.py + decoder.py) vs oracle and stock bzip2.

Runs on the CPU platform (conftest); the same XLA programs run on the GPU
in tests/test_gpu.py and chip_smoke.py.  Level 1 keeps the static
shapes small enough to compile quickly in the suite.
"""
import bz2 as stdlib_bz2

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bzip2_tpu import crc as hostcrc  # noqa: E402
from bzip2_tpu import rle1  # noqa: E402
from bzip2_tpu.api import DataError  # noqa: E402
from bzip2_tpu.oracle import bwt as obwt  # noqa: E402
from bzip2_tpu.ops import decode as D  # noqa: E402


def test_crc32_device_matches_host(rng):
    for L in (0, 1, 63, 64, 1000, 4096):
        msg = rng.integers(0, 256, L).astype(np.uint8)
        pad = np.zeros((1, 4096), np.int32)
        pad[0, :L] = msg
        got = int(np.asarray(D.crc32_device(
            jnp.asarray(pad), jnp.asarray([L], jnp.int32), n_lanes=16))[0])
        assert got == hostcrc.crc32(msg.tobytes())


def test_rle1_inverse_device(rng):
    cases = [b"a" * 101, b"a" * 4, b"a" * 5, b"a" * 104, b"x",
             bytes([97] * 4 + [98] * 255 + [99] * 1000)]
    for _ in range(10):
        L = int(rng.integers(1, 3000))
        raw = rng.integers(0, 5, L).astype(np.uint8)
        raw[rng.random(L) < 0.3] = 97
        cases.append(raw.tobytes())
    for raw in cases:
        enc = rle1.encode_blocks(raw, 9)[0].data
        x = np.zeros((1, 4096), np.int32)
        x[0, :enc.size] = enc
        out, olen, fits = D.rle1_inverse(
            jnp.asarray(x), jnp.asarray([enc.size], jnp.int32), 4096)
        assert bool(fits[0])
        assert np.asarray(out)[0][:int(olen[0])].astype(
            np.uint8).tobytes() == raw


def test_ibwt_device_small(rng):
    blks = [rng.integers(0, 5, int(rng.integers(2, 400))).astype(np.uint8)
            for _ in range(6)]
    N = 512
    lastp = np.zeros((6, N), np.int32)
    ns, origs = [], []
    for i, b in enumerate(blks):
        last, orig = obwt.bwt(b)
        lastp[i, :b.size] = last
        ns.append(b.size)
        origs.append(orig)
    out, ok = D.ibwt(jnp.asarray(lastp), jnp.asarray(ns, jnp.int32),
                     jnp.asarray(origs, jnp.int32), n_walkers=16)
    assert np.asarray(ok).all()
    for i, b in enumerate(blks):
        assert (np.asarray(out)[i][:b.size] == b).all()


@pytest.fixture(scope="module")
def dec():
    from bzip2_tpu.decoder import DeviceDecoder
    return DeviceDecoder()


def test_device_decode_roundtrip(dec, golden):
    data = golden[1][0]
    comp = stdlib_bz2.compress(data, 1)
    assert dec.decompress(comp) == data


def test_device_decode_multiblock_multimember(dec, golden):
    data = (golden[2][0] * 3)[:450_000]
    comp = stdlib_bz2.compress(data, 1)
    assert dec.decompress(comp) == data
    comp1 = stdlib_bz2.compress(b"hello device world", 1)
    assert dec.decompress(comp1 + comp) == b"hello device world" + data


def test_device_decode_our_encoder(dec, golden):
    from bzip2_tpu import api
    data = golden[3][0]
    comp = api.compress(data, 1)
    assert dec.decompress(comp) == data


def test_device_decode_corrupt_clean_error(dec, golden):
    data = (golden[2][0])[:150_000]
    comp = bytearray(stdlib_bz2.compress(data, 1))
    for pos in (10, 100, 1000, len(comp) // 2, len(comp) - 5):
        bad = bytearray(comp)
        bad[pos] ^= 0x10
        try:
            out = dec.decompress(bytes(bad))
            # a flip that still decodes must round-trip honestly
            assert isinstance(out, bytes)
        except DataError:
            pass
    with pytest.raises(DataError):
        dec.decompress(b"not a bzip2 stream at all")


def test_device_decode_api_and_cli_surface(dec, golden):
    from bzip2_tpu import api
    data = golden[1][0]
    comp = stdlib_bz2.compress(data, 1)
    assert api.decompress(comp, backend="device") == data


def test_device_decode_tail_and_multistream(dec, golden):
    data = golden[1][0]
    comp = stdlib_bz2.compress(data, 1)
    out, consumed = dec.decompress_with_tail(comp + b"garbagegarbage")
    assert out == data and consumed == len(comp)
    # multi_stream=False stops after the first member
    comp2 = stdlib_bz2.compress(b"tail member", 1)
    out, consumed = dec.decompress_with_tail(comp + comp2,
                                             multi_stream=False)
    assert out == data and consumed == len(comp)
    out, consumed = dec.decompress_with_tail(comp + comp2,
                                             multi_stream=True)
    assert out == data + b"tail member" and consumed == len(comp) + len(comp2)


def test_device_decode_batch_heal(dec, golden, monkeypatch, capfd):
    """A lane anomaly in one batch is healed on the host per batch; the
    device keeps decoding the rest of the stream."""
    data = (golden[2][0] * 24)[:2_900_000]
    comp = stdlib_bz2.compress(data, 1)
    calls = {"n": 0}
    real = dec._decode_batch

    def flaky(stream, level, pbs):
        calls["n"] += 1
        if calls["n"] == 1:
            return None  # simulate a lane anomaly on the first batch
        return real(stream, level, pbs)

    monkeypatch.setattr(dec, "_decode_batch", flaky)
    assert dec.decompress(comp) == data
    assert calls["n"] >= 2, "device decode did not continue after healing"
    assert "healed on host" in capfd.readouterr().err


def _realistic_level9_stream(golden, n_bytes=2_030_000):
    """Deterministic ~2 MB of real mixed text -> 2+ full ~900k -9 blocks
    (committed golden samples, so identical on every machine)."""
    data = ((golden[1][0] + golden[2][0] + golden[3][0]) * 8)[:n_bytes]
    return data, stdlib_bz2.compress(data, 9)


def test_device_decode_level9_realistic_zero_anomalies(dec, golden):
    """Realistic -9 fixture pinned in CI.  The walker cap, the two-level
    LUT escape region, and the wave-2 compaction are backend-independent
    logic — a regression in any of them flips ANOMALIES here and fails
    this test on the CPU suite, before any card run."""
    from bzip2_tpu import decoder as dmod

    data, comp = _realistic_level9_stream(golden)
    before = dict(dmod.ANOMALIES)
    assert dec.decompress(comp) == data
    assert dmod.ANOMALIES["lane"] == before["lane"], \
        "lane anomaly healed on a well-formed -9 stream"
    assert dmod.ANOMALIES["batch"] == before["batch"], \
        "batch anomaly healed on a well-formed -9 stream"


def test_device_decode_level9_real_heal(dec, golden, monkeypatch):
    """The REAL heal path (not a simulated _decode_batch failure) at -9:
    squeezing the IBWT budget makes wave-2 overflow on a ~900k block, the
    lane flags ok=False, and the host heals exactly that block."""
    import functools

    from bzip2_tpu import decoder as dmod
    from bzip2_tpu.ops import decode as D

    data, comp = _realistic_level9_stream(golden)
    orig_ibwt = D.ibwt
    monkeypatch.setattr(D, "ibwt", functools.partial(orig_ibwt, budget=2))
    dec2 = dmod.DeviceDecoder()   # fresh jit cache picks up the patch
    before = dict(dmod.ANOMALIES)
    assert dec2.decompress(comp) == data
    healed = (dmod.ANOMALIES["lane"] - before["lane"]
              + dmod.ANOMALIES["batch"] - before["batch"])
    assert healed > 0, "squeezed budget must exercise the real heal path"


def test_decode_symbols_rows_matches_flat(golden):
    """The row-addressed symbol decoder (the mesh path's formulation) must
    produce the same symbol stream as the flat-buffer one."""
    from bzip2_tpu import native

    data = golden[2][0][:180_000]
    comp = stdlib_bz2.compress(data, 1)
    buf = np.frombuffer(comp, np.uint8)
    pbs = []
    pos = 32
    while True:
        pb, _rc = native.parse_block(buf, pos, 1)
        if pb is None:
            break
        pb.start_bit = pos
        pbs.append(pb)
        pos = pb.end_bit
    assert pbs, "fixture produced no blocks"
    B = len(pbs)
    G = max(pb.n_groups_used for pb in pbs)
    lens6 = np.stack([pb.lens for pb in pbs])
    alpha = np.array([pb.n_used + 2 for pb in pbs], np.int32)
    lut1, lut2, ebase = D.build_tables(jnp.asarray(lens6),
                                       jnp.asarray(alpha))

    # flat form: one shared buffer, absolute offsets
    wt_flat = buf.size // 4 + 2
    flat_b = np.zeros(wt_flat * 4, np.uint8)
    flat_b[: buf.size] = buf
    words_flat = flat_b.view(">u4").astype(np.uint32)
    goff_f = np.zeros((B, G), np.int32)
    gsel = np.zeros((B, G), np.int32)
    gvalid = np.zeros((B, G), bool)
    for i, pb in enumerate(pbs):
        g = pb.n_groups_used
        goff_f[i, :g] = pb.group_offsets
        gsel[i, :g] = pb.selectors[:g]
        gvalid[i, :g] = True
    syms_flat = np.asarray(D.decode_symbols(
        jnp.asarray(words_flat), jnp.asarray(goff_f), jnp.asarray(gsel),
        jnp.asarray(gvalid), lut1, lut2, ebase))

    # row form: per-block word rows, row-local offsets
    need = max(((pb.end_bit + 31) // 32 + 1) - pb.sym_start_bit // 32
               for pb in pbs)
    wt = 1 << max(6, need - 1).bit_length()
    words_r = np.zeros((B, wt), np.uint32)
    goff_r = np.zeros((B, G), np.int32)
    for i, pb in enumerate(pbs):
        wbase = pb.sym_start_bit // 32
        span = buf[wbase * 4: min(((pb.end_bit + 31) // 32 + 1) * 4,
                                  buf.size)]
        row = np.zeros(wt * 4, np.uint8)
        row[: span.size] = span
        words_r[i] = row.view(">u4").astype(np.uint32)
        goff_r[i, : pb.n_groups_used] = pb.group_offsets - wbase * 32
    syms_rows = np.asarray(D.decode_symbols_rows(
        jnp.asarray(words_r), jnp.asarray(goff_r), jnp.asarray(gsel),
        jnp.asarray(gvalid), lut1, lut2, ebase))

    valid = np.repeat(gvalid, 50, axis=1)
    assert np.array_equal(syms_flat[valid], syms_rows[valid])
