#!/usr/bin/env python
"""Sharded (mesh-path) encode+decode throughput at -9 on real hardware.

Runs the SPMD programs from parallel/mesh.py — the same sharded code the
multi-chip dryrun validates — on a mesh of all local devices and prints
per-device MB/s.  Inputs vary per repetition.

Usage: python tools/mesh_bench.py [n_batches]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(m):
    sys.stderr.write(f"[mesh {time.strftime('%H:%M:%S')}] {m}\n")
    sys.stderr.flush()


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    import jax
    from bzip2_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    log(f"devices: {jax.devices()}")

    from bench import make_corpus
    from bzip2_tpu import rle1 as _rle1
    from bzip2_tpu.engine import Engine, _block_pad_size, _words_for
    from bzip2_tpu.parallel import mesh as M

    level = 9
    N = _block_pad_size(level)
    W = _words_for(N)
    bsz = Engine()._batch_size_for(level)
    data = make_corpus((reps + 1) * bsz * 900_000)
    blocks = _rle1.encode_blocks(data, level)
    msh = M.make_mesh()

    # ---- sharded fused encode ----
    batches = []
    for r in range(reps + 1):
        chunk = blocks[r * bsz:(r + 1) * bsz]
        if len(chunk) < bsz:
            break
        arr = np.zeros((bsz, N), np.uint8)
        ns = np.ones(bsz, np.int32)
        uses = np.zeros((bsz, 256), bool)
        crcs = np.zeros(bsz, np.uint32)
        raw_bytes = 0
        for j, blk in enumerate(chunk):
            arr[j, :blk.data.size] = blk.data
            ns[j] = blk.data.size
            uses[j] = blk.in_use
            crcs[j] = blk.crc
            raw_bytes += blk.raw_span[1] - blk.raw_span[0]
        batches.append((arr, ns, uses, crcs, raw_bytes))

    M.encode_blocks_sharded(msh, *batches[0][:4], n_words=W)  # compile
    walls = []
    for arr, ns, uses, crcs, raw in batches[1:]:
        t0 = time.time()
        M.encode_blocks_sharded(msh, arr, ns, uses, crcs, n_words=W)
        w = time.time() - t0
        walls.append((w, raw))
        log(f"sharded encode batch: {w:.2f}s -> {raw / 1e6 / w:.2f} MB/s/chip")
    bw = min(r / w for w, r in walls) / 1e6
    log(f"sharded fused encode -9: best {bw:.2f} MB/s/chip "
        f"({len(batches[0][0])} blocks/batch)")

    # ---- sharded decode ----
    eng = Engine(use_device=False)          # host-only: keep this process's
    streams = []                            # device programs mesh-only
    for r in range(reps + 1):
        sl = data[r * (8 << 20):(r + 1) * (8 << 20)]
        streams.append((eng.compress(sl, level), len(sl)))
    M.decode_blocks_sharded(msh, streams[0][0], level)        # compile
    dwalls = []
    for comp, raw in streams[1:]:
        t0 = time.time()
        out = M.decode_blocks_sharded(msh, comp, level)
        w = time.time() - t0
        assert len(out) == raw
        dwalls.append((w, raw))
        log(f"sharded decode: {w:.2f}s -> {raw / 1e6 / w:.2f} MB/s/chip "
            f"(heals={M.HEALS['lane']})")
    dw = min(r / w for w, r in dwalls) / 1e6
    log(f"sharded decode -9: best {dw:.2f} MB/s/chip, heals={M.HEALS['lane']}")


if __name__ == "__main__":
    main()
