#!/usr/bin/env python
"""Benchmark: single-GPU compress + decompress throughput at -9.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"card"}.  Runs only on a GPU: without one it exits non-zero and prints no
result.

Corpus: real non-repeating text — a deterministic walk of the Python
sources installed on this machine (~500 MB available).  Naively repeating
one golden sample makes every 900k block internally periodic — rotations
tie until k ~ period, the worst case for any comparison/doubling-based
sorter and unrepresentative of real data.  The reference is insensitive to
the corpus switch, so the baseline was re-measured on the exact same bytes.

Baseline (BASELINE.md: the reference C binary on one core of an earlier
development VM, 85 MB of this corpus, 2026-08-16, best of 2): encode -9
22.4 MB/s + decode 35.6 MB/s => combined round-trip 13.7 MB/s.
vs_baseline is the ratio of our combined round-trip throughput to that;
the baseline is not yet re-measured on the GPU machine's host.

Env knobs: BENCH_BYTES (default 85 MB — the exact span the reference
baseline was measured on; a shorter prefix of the corpus is measurably
harder, ratio 5.9:1 vs 7.3:1, and would compare our throughput on hard
bytes against the reference's on easier ones), BENCH_LEVEL (default 9).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


BASELINE_COMBINED_MBS = 85_000_000 / (3.80 + 2.39) / 1e6  # 13.7 MB/s


def log(msg):
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def make_corpus(size: int) -> bytes:
    """Realistic text corpus: concatenated Python stdlib sources (real,
    non-repeating text — the representative workload for a general-purpose
    compressor; a deterministic sorted file walk makes it reproducible on
    this machine, where the reference baseline is measured on the same
    bytes).  Cached to .bench_corpus.bin so repeat runs skip the file walk.
    Falls back to a de-periodized mix of the golden samples when no stdlib
    tree is present."""
    import glob
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_corpus.bin")
    try:
        if os.path.getsize(cache) >= size:
            with open(cache, "rb") as fh:
                return fh.read(size)
    except OSError:
        pass
    seen = set()
    files = []
    for pat in ("/usr/lib/python3*/**/*.py", "/opt/venv/**/*.py"):
        for f in sorted(glob.glob(pat, recursive=True)):
            r = os.path.realpath(f)
            if r not in seen:
                seen.add(r)
                files.append(r)
    buf = bytearray()
    for f in files:
        try:
            with open(f, "rb") as fh:
                buf += fh.read()
        except OSError:
            continue
        if len(buf) >= size:
            try:
                with open(cache, "wb") as fh:
                    fh.write(buf[:size])
            except OSError:
                pass
            return bytes(buf[:size])

    return golden_mix(size, bytes(buf))


def golden_mix(size: int, prefix: bytes = b"",
               seed: int = 20260816) -> bytes:
    """``prefix`` then a cycle of the committed golden samples 1/2/3 with
    ~1% keyed letter rotations per repeat (de-periodized: no block is
    exactly periodic), cut to ``size`` bytes."""
    here = os.path.dirname(os.path.abspath(__file__))
    srcs = []
    for i in (1, 2, 3):
        with open(os.path.join(here, f"tests/golden/sample{i}.ref"),
                  "rb") as fh:
            srcs.append(fh.read())
    buf = bytearray(prefix)
    rng = np.random.default_rng(seed)
    i = 0
    while len(buf) < size:
        s = np.frombuffer(srcs[i % 3], np.uint8).copy()
        pos = rng.integers(0, s.size, max(1, s.size // 100))
        add = rng.integers(0, 26, pos.size)
        s[pos] = (((s[pos].astype(np.int32) - 97) % 26 + add) % 26 + 97
                  ).astype(np.uint8)
        buf += s.tobytes()
        i += 1
    return bytes(buf[:size])


def main():
    from bzip2_tpu import native
    from bzip2_tpu.compile_cache import enable_compile_cache
    from bzip2_tpu.device import card_info, require_gpu

    device = require_gpu()
    card = card_info()
    enable_compile_cache()
    from bzip2_tpu.engine import Engine

    level = int(os.environ.get("BENCH_LEVEL", "9"))
    target = int(os.environ.get("BENCH_BYTES", str(85_000_000)))
    t0 = time.time()
    data = make_corpus(target)
    t_corpus = time.time() - t0
    log(f"device: {device}  card: {card}  level={level}  "
        f"input={len(data) / 1e6:.1f} MB")

    eng = Engine()
    # Warm phases (each logged; Engine.prepare issues the stage compiles
    # from parallel threads, and the persistent cache turns reruns into
    # executable loads):
    #   heap  — pre-fault host memory (first-touch faults on some VMs
    #           run ~100x slower than reuse; see bzip2_tpu/hostmem.py)
    #   prep  — device executable compile/load (parallel)
    #   pass  — one full untimed encode+decode (page/TLB warm, JIT of the
    #           remaining small host paths)
    from bzip2_tpu import hostmem
    t0 = time.time()
    # heap pre-fault is pure host memory; overlap it with device prep
    import threading
    ht = threading.Thread(
        target=hostmem.warm_heap,
        args=(min(512 << 20, 4 * len(data) + (256 << 20)),))
    ht.start()
    eng.prepare(level)
    ht.join()
    t_prep = time.time() - t0
    t0 = time.time()
    # warm pass on ONE primary-batch slice (+decode): binds the remaining
    # dispatch caches and JITs the host glue
    from bzip2_tpu import engine as _engine
    wslice = data[: min(len(data), eng.AUTO_BATCH_BYTES)]
    native.decompress(eng.compress(wslice, level))
    t_pass = time.time() - t0
    # reset host-rate telemetry (the warm slice skews it); keep dev_wall:
    # the warm-measured device wall (even if pessimistic) lets the
    # scheduler decline honestly instead of gating run 1 on a blind claim
    eng._sched.update({"host_done": 0, "host_time": 0.0})
    log(f"warm: corpus {t_corpus:.1f}s + heap||device-prep {t_prep:.1f}s "
        f"+ warm-pass {t_pass:.1f}s "
        f"= {t_corpus + t_prep + t_pass:.1f}s")

    # Timed runs, phase-hopped: the earlier development VM's throughput
    # oscillated +-20% in multi-minute phases, so the encode/decode samples
    # are spread over BENCH_ROUNDS rounds separated by pauses and the
    # global best is taken (medians are the benchmark's next change).
    _engine.reset_telemetry()
    n_rounds = int(os.environ.get("BENCH_ROUNDS", "4"))
    enc_runs, dec_runs = [], []
    comp = None
    for rnd in range(n_rounds):
        if rnd:
            time.sleep(min(45.0, len(data) / 2e6))
        t0 = time.time()
        comp = eng.compress(data, level)
        enc_runs.append(time.time() - t0)
        t0 = time.time()
        out, _, rc = native.decompress(comp)
        dec_runs.append(time.time() - t0)
        assert rc == 0 and out == data, "round-trip mismatch!"
        log(f"round {rnd}: encode {len(data)/1e6/enc_runs[-1]:.2f} "
            f"decode {len(data)/1e6/dec_runs[-1]:.2f} MB/s")
    t_enc = min(enc_runs)
    t_dec = min(dec_runs)
    log(f"encode: {t_enc:.2f}s -> {len(data) / 1e6 / t_enc:.2f} MB/s "
        f"(ratio {len(data) / len(comp):.2f}:1; runs "
        f"{' '.join(f'{r:.2f}' for r in sorted(enc_runs))})")
    log(f"decode: {t_dec:.2f}s -> {len(data) / 1e6 / t_dec:.2f} MB/s "
        f"(runs {' '.join(f'{r:.2f}' for r in sorted(dec_runs))})")

    # Encode telemetry: who actually encoded the stream, and where the
    # device time went.
    sh = dict(_engine.SHARE)
    tot_blocks = sh["dev_blocks"] + sh["host_blocks"]
    if tot_blocks:
        log(f"encode share over {n_rounds} timed runs: device "
            f"{sh['dev_blocks']}/{tot_blocks} blocks "
            f"({100.0 * sh['dev_blocks'] / tot_blocks:.0f}%), host "
            f"{sh['host_blocks']}, declines {sh['declines']}")
    if _engine.STAGE_WALL:
        log("encode device stage walls (s, cumulative): "
            f"{ {k: round(v, 2) for k, v in _engine.STAGE_WALL.items()} }")

    # Device decode path (device Huffman/MTF^-1/RLE2/IBWT/RLE1^-1;
    # decoder.py): measured on one batch-sized slice and reported as a
    # secondary metric.  The primary decode number above is the product's
    # default backend, the native host decoder.  A failure here fails the
    # run.
    if os.environ.get("BENCH_DEVICE_DECODE", "1") != "0":
        from bzip2_tpu import decoder as _decoder
        ddec = _decoder.DeviceDecoder()
        dslice = data[:24 << 20]
        dcomp = eng.compress(dslice, level)
        t0 = time.time()
        dout = ddec.decompress(dcomp)    # compile/load + run
        warm_dd = time.time() - t0
        _decoder.STAGE_WALL.clear()
        _decoder.ANOMALIES.update({"lane": 0, "batch": 0})
        t0 = time.time()
        dout = ddec.decompress(dcomp)
        t_dd = time.time() - t0
        assert dout == dslice, "device decode mismatch!"
        log(f"device decode ({device['kind']}): "
            f"{len(dslice) / 1e6 / t_dd:.2f} MB/s on "
            f"{len(dslice) / 1e6:.0f} MB (warm {warm_dd:.1f}s)")
        log("device decode stage walls (s): "
            f"{ {k: round(v, 2) for k, v in _decoder.STAGE_WALL.items()} }"
            f"; anomalies healed: lane={_decoder.ANOMALIES['lane']} "
            f"batch={_decoder.ANOMALIES['batch']}")

    # correctness cross-check vs stock bzip2
    import bz2
    assert bz2.decompress(comp) == data
    exp = bz2.compress(data, level)
    bit_exact = comp == exp
    log(f"bit-exact vs stock bzip2 -{level}: {bit_exact} "
        f"(sizes {len(comp)} vs {len(exp)})")

    combined = len(data) / 1e6 / (t_enc + t_dec)
    print(json.dumps({
        "metric": f"single-GPU compress+decompress MB/s at -{level} "
                  f"(bit-exact={bit_exact})",
        "value": round(combined, 3),
        "unit": "MB/s",
        "vs_baseline": round(combined / BASELINE_COMBINED_MBS, 3),
        "device": device,
        "card": card,
    }))


if __name__ == "__main__":
    main()
