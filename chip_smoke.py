#!/usr/bin/env python
"""Smoke test of the codec's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-10 below
    python chip_smoke.py --four-cards  # only the 4-card mesh encode/decode

One process drives the card(s).  Each phase prints one line; any failure
raises and the script exits non-zero before its last line, which is
exactly ``{"ok": true, "device": {"platform", "kind", "count"}}``.
Without a GPU (or outside a checkout of this repository) it exits
non-zero and prints no result.  Every time printed is one unrepeated run
on the card named in phase 1.

Phases: 1 device + card + native runtime; 2 input from the committed
golden samples; 3 -9 encode through ``bzip2_tpu.compress`` with every
block on the device; 4 the same at -1 plus a periodic and a run-heavy
block; 5 the default scheduler (one host worker); 6 the fused program;
7 device decode of the -9 and -1 streams; 8 the CLI; 9 the ``gpu``-marked
tests; 10 the MTF kernel against its XLA reference at -9 widths.
"""
import argparse
import bz2
import functools
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from bench import golden_mix  # noqa: E402
from bzip2_tpu import native  # noqa: E402
from bzip2_tpu.device import card_info, require_gpu  # noqa: E402

#: input sizes: >= 3 full 13-block device batches at -9, >= 2 full
#: 125-block batches at -1, one -1 batch for the fused program
SIZE9 = 36 << 20
SIZE1 = 26 << 20
FUSED1 = 12_000_000
CLI_BYTES = 3_000_000
#: the --four-cards stream: 8 full blocks at this level, two per card
MESH_LEVEL = 9


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def device_walls(fn, args, reps=5):
    """Warm once, then the min and median of ``reps`` device walls (each
    ends in block_until_ready)."""
    import jax
    out = jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return out, walls[0], walls[len(walls) // 2]


def encode_phase(phase, data, level, eng, expected):
    """Compile, then encode twice through the API with every block on the
    device; returns the stream."""
    import bzip2_tpu
    from bzip2_tpu import engine, rle1
    n_blocks = len(rle1.encode_blocks(data, level))
    _, compile_s = timed(eng.prepare, level)
    walls = []
    for _ in range(2):
        engine.reset_telemetry()
        out, wall = timed(bzip2_tpu.compress, data, level)
        walls.append(wall)
        share = dict(engine.SHARE)
        assert share["dev_blocks"] == n_blocks and share["host_blocks"] == 0, \
            (share, n_blocks)
        assert out == expected, f"-{level} stream differs from bz2"
    say(phase, f"-{level} encode: {len(data)} B, {n_blocks} blocks, all on "
        f"the device, bit-exact vs bz2; compile {compile_s:.1f} s, first "
        f"wall {walls[0]:.2f} s, warm wall {walls[1]:.2f} s "
        f"({len(data) / 1e6 / walls[1]:.2f} MB/s) on this card")
    return out


def memory_phase(phase, eng, level):
    import jax
    import jax.numpy as jnp
    from bzip2_tpu.engine import _block_pad_size
    bsz = eng._batch_size_for(level)
    N = _block_pad_size(level)
    f_pre = eng._fns(level, bsz)[0]
    ma = f_pre.lower(jax.ShapeDtypeStruct((bsz, N), jnp.uint8),
                     jax.ShapeDtypeStruct((bsz,), jnp.int32),
                     jax.ShapeDtypeStruct((bsz, 256), jnp.bool_)
                     ).compile().memory_analysis()
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(phase, f"encode_pre (-{level}, {bsz}x{N}) memory_analysis: "
        f"temp {ma.temp_size_in_bytes} B, arguments "
        f"{ma.argument_size_in_bytes} B, outputs {ma.output_size_in_bytes} "
        f"B; device peak_bytes_in_use {peak} B")


def decode_phase(phase, stream, data, level):
    from bzip2_tpu import api, decoder
    decoder.ANOMALIES.update({"lane": 0, "batch": 0})
    decoder.STAGE_WALL.clear()
    out, wall = timed(functools.partial(api.decompress, backend="device"),
                      stream)
    assert out == data, f"-{level} device decode differs"
    assert decoder.ANOMALIES == {"lane": 0, "batch": 0}, decoder.ANOMALIES
    walls = {k: round(v, 3) for k, v in decoder.STAGE_WALL.items()}
    say(phase, f"-{level} device decode: byte-equal, anomalies 0, wall "
        f"{wall:.2f} s incl. compile; stage walls (s) {walls}")


def cli_phase(phase, data):
    from bzip2_tpu import cli
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "smoke.bin")
        with open(path, "wb") as fh:
            fh.write(data)
        assert cli.main(["-z", "-9", "--backend=tpu", "-f", path]) == 0
        with open(path + ".bz2", "rb") as fh:
            comp = fh.read()
        assert comp == bz2.compress(data, 9), "CLI -z output differs"
        assert not os.path.exists(path)
        assert cli.main(["-d", "--backend=tpu", "-f", path + ".bz2"]) == 0
        with open(path, "rb") as fh:
            assert fh.read() == data, "CLI -d output differs"
    say(phase, f"CLI -z -9 / -d --backend=tpu on {len(data)} B: cmp-equal "
        "with bz2")


def gpu_tests_phase(phase):
    import pytest

    class Tally:
        passed = 0
        other = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other.append((report.nodeid, report.outcome))

    tally = Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")], plugins=[tally])
    assert rc == 0 and tally.passed and not tally.other, (rc, tally.other)
    say(phase, f"{tally.passed} gpu-marked tests passed")


def mtf_kernel_phase(phase, data, B=13, N=None):
    """The Triton MTF kernel against the XLA formulation at -9 widths:
    integer ranks, compared with equality."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bzip2_tpu.engine import MTF_TILE, _block_pad_size
    from bzip2_tpu.ops.mtf import mtf_ranks_xla
    from bzip2_tpu.ops.mtf_gpu import mtf_ranks_gpu

    N = N or _block_pad_size(9)
    raw = np.frombuffer(data[:B * N], np.uint8).reshape(B, N).astype(np.int32)
    raw[1] = np.sort(raw[1])                 # run-heavy lane
    raw[2] = raw[2] % 3                      # 3-symbol alphabet
    ns = np.full(B, N, np.int32)
    ns[3:] = N - 19 - np.arange(B - 3) * (N // 300)  # partial last tiles
    valid = np.arange(N)[None, :] < ns[:, None]
    seq, val = jnp.asarray(np.where(valid, raw, 0)), jnp.asarray(valid)
    xla = jax.jit(functools.partial(mtf_ranks_xla, tile=MTF_TILE))
    want, x_min, x_med = device_walls(xla, (seq, val))
    got, k_min, k_med = device_walls(mtf_ranks_gpu, (seq, val))
    want, got = np.asarray(want), np.asarray(got)
    assert np.array_equal(np.where(valid, got, 0), np.where(valid, want, 0))
    say(phase, f"MTF ranks {B}x{N}: Triton kernel == XLA (exact); device "
        f"wall min/median: kernel {k_min * 1e3:.2f}/{k_med * 1e3:.2f} ms, "
        f"XLA {x_min * 1e3:.2f}/{x_med * 1e3:.2f} ms on this card")


def one_card():
    device = require_gpu()
    # (importing bzip2_tpu built the native runtime before JAX started)
    assert native.available(), "native host runtime failed to build"
    import jax
    say(1, f"JAX platform {jax.default_backend()}, {device['kind']}, "
        f"{device['count']} device(s)")
    say(1, f"card (name, power limit): {card_info()}")

    from bzip2_tpu.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    data9 = golden_mix(SIZE9)
    # the run stays short enough that its block's RLE1 expansion fits the
    # device decoder's output bucket (longer runs are healed by design)
    data1 = golden_mix(SIZE1, seed=7) + b"abcab" * 50_000 + b"Q" * 20_000
    say(2, f"inputs from the golden samples: -9 {len(data9)} B, -1 "
        f"{len(data1)} B (with a periodic and a run-heavy tail); compile "
        f"cache {cache}")

    import bzip2_tpu
    from bzip2_tpu.engine import Engine
    eng = bzip2_tpu.enable_tpu_backend(host_workers=0)
    say(3, f"engine mode {eng.mode} (native host runtime built), host "
        f"workers {eng.host_workers}")
    stream9 = encode_phase(3, data9, 9, eng, bz2.compress(data9, 9))
    memory_phase(3, eng, 9)
    stream1 = encode_phase(4, data1, 1, eng, bz2.compress(data1, 1))

    from bzip2_tpu import engine
    dflt = Engine()
    engine.reset_telemetry()
    out, wall = timed(dflt.compress, data9, 9)
    assert out == stream9, "default scheduler stream differs"
    sh = engine.SHARE
    say(5, f"default Engine ({dflt.mode}, {dflt.host_workers} host worker): "
        f"bit-exact, device share {sh['dev_blocks']}/"
        f"{sh['dev_blocks'] + sh['host_blocks']} blocks, wall {wall:.2f} s")

    fused = Engine(mode="fused", host_workers=0)
    one = data1[:FUSED1]
    engine.reset_telemetry()
    out, wall = timed(fused.compress, one, 1)
    assert out == bz2.compress(one, 1), "fused -1 stream differs"
    assert engine.SHARE["host_blocks"] == 0
    say(6, f"fused program -1, one batch of {engine.SHARE['dev_blocks']} "
        f"blocks: bit-exact, wall {wall:.2f} s incl. compile")

    decode_phase(7, stream9, data9, 9)
    decode_phase(7, stream1, data1, 1)
    cli_phase(8, data9[:CLI_BYTES])
    gpu_tests_phase(9)
    mtf_kernel_phase(10, data9)
    return device


def four_cards():
    import jax
    import numpy as np
    device = require_gpu()
    assert device["count"] == 4, device
    say("4x", f"{device['kind']} x{device['count']}; card (name, power "
        f"limit): {card_info()}")
    from bzip2_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    from bzip2_tpu import constants as C
    from bzip2_tpu import rle1
    from bzip2_tpu.engine import _block_pad_size, _words_for, assemble_stream
    from bzip2_tpu.parallel.mesh import (build_sharded_encoder,
                                         decode_blocks_sharded,
                                         encode_blocks_sharded, make_mesh)

    level = MESH_LEVEL
    data = golden_mix(8 * C.nblock_max(level))
    blocks = rle1.encode_blocks(data, level)
    assert len(blocks) == 8, len(blocks)
    N = _block_pad_size(level)
    W = _words_for(N)
    arr = np.zeros((8, N), np.uint8)
    ns = np.array([b.data.size for b in blocks], np.int32)
    uses = np.stack([b.in_use for b in blocks])
    crcs = np.array([b.crc for b in blocks], np.uint32)
    for j, b in enumerate(blocks):
        arr[j, :b.data.size] = b.data
    expected = bz2.compress(data, level)

    def run(mesh):
        words, nbits = encode_blocks_sharded(mesh, arr, ns, uses, crcs, W)
        payloads = []
        for j in range(8):
            nb = int(nbits[j])
            by = words[j, : (nb + 31) // 32].byteswap().view(np.uint8)
            payloads.append((by[: (nb + 7) // 8], nb))
        return assemble_stream(payloads, blocks, level)

    results = {}
    for name, devs in (("4 cards", jax.devices()[:4]),
                       ("1 card", jax.devices()[:1])):
        mesh = make_mesh(devs)
        stream = run(mesh)                          # compile + run
        stream, enc_wall = timed(run, mesh)
        assert stream == expected, f"{name}: sharded stream differs"
        out = decode_blocks_sharded(mesh, stream, level)  # compile + run
        out, dec_wall = timed(decode_blocks_sharded, mesh, stream, level)
        assert out == data, f"{name}: sharded decode differs"
        results[name] = (enc_wall, dec_wall)
        if len(devs) == 4:
            from jax.sharding import NamedSharding, PartitionSpec
            sh = NamedSharding(mesh, PartitionSpec("blocks"))
            ins = [jax.device_put(x, sh) for x in (arr, ns, uses, crcs)]
            for x in ins:
                assert sorted(s.data.shape[0] for s in x.addressable_shards
                              ) == [2, 2, 2, 2], x.sharding
            words, nbits = build_sharded_encoder(mesh, W)(*ins)
            placed = sorted(d.id for d in words.sharding.device_set)
            rows = {s.device.id: s.data.shape[0]
                    for s in words.addressable_shards}
            assert placed == sorted(d.id for d in devs), placed
            assert sorted(rows.values()) == [2, 2, 2, 2], rows
            assert len(nbits.sharding.device_set) == 4
            say("4x", f"inputs and words sharded {words.sharding.spec} over "
                f"devices {placed}, rows per device {rows}; nbits "
                "replicated")
        say("4x", f"{name}: 8 -{level} blocks bit-exact vs bz2, decode "
            f"round-trips; warm encode wall {enc_wall:.2f} s, decode wall "
            f"{dec_wall:.2f} s on these cards")
    return device


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded encode/decode on 4 cards")
    args = ap.parse_args()
    device = four_cards() if args.four_cards else one_card()
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
