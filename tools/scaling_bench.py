#!/usr/bin/env python
"""Block-DP scaling efficiency over a virtual CPU mesh (BASELINE #3/#4).

Runs the sharded block encoder on 1/2/4/8 virtual devices with a fixed
per-device load (weak scaling: B = 2 blocks per device).  All virtual
devices share one physical core, so this cannot demonstrate parallel
speedup; the datum is that per-block cost does NOT grow with device count
(>= 100% relative efficiency) — the mesh program adds no sharding/
collective overhead.

Usage: JAX_PLATFORMS=cpu python tools/scaling_bench.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402

from bzip2_tpu import rle1 as _rle1  # noqa: E402
from bzip2_tpu.engine import _words_for  # noqa: E402
from bzip2_tpu.parallel.mesh import encode_blocks_sharded, make_mesh  # noqa: E402


def main():
    level = 1
    rng = np.random.default_rng(7)
    per_dev = 2
    data = rng.integers(97, 107, 16 * 95_000, dtype=np.uint8).tobytes()
    blocks = _rle1.encode_blocks(data, level)
    N = -(-max(b.data.size for b in blocks) // 512) * 512
    W = _words_for(N)

    def batch(nblocks):
        arr = np.zeros((nblocks, N), np.uint8)
        ns = np.ones(nblocks, np.int32)
        uses = np.zeros((nblocks, 256), bool)
        crcs = np.zeros(nblocks, np.uint32)
        for j in range(nblocks):
            b = blocks[j % len(blocks)]
            arr[j, :b.data.size] = b.data
            ns[j] = b.data.size
            uses[j] = b.in_use
            crcs[j] = b.crc
        return arr, ns, uses, crcs

    base_per_block = None
    print(f"{'devices':>8} {'blocks':>7} {'wall s':>8} {'s/block':>9} "
          f"{'efficiency':>11}")
    for d in (1, 2, 4, 8):
        mesh = make_mesh(jax.devices()[:d])
        B = per_dev * d
        arr, ns, uses, crcs = batch(B)
        encode_blocks_sharded(mesh, arr, ns, uses, crcs, W)  # compile
        t0 = time.time()
        words, nbits = encode_blocks_sharded(mesh, arr, ns, uses, crcs, W)
        dt = time.time() - t0
        per_block = dt / B
        if base_per_block is None:
            base_per_block = per_block
        eff = base_per_block / per_block
        print(f"{d:>8} {B:>7} {dt:>8.2f} {per_block:>9.3f} {eff:>10.0%}"
              + ("  (fixed-cost amortization; >=100% = no sharding overhead)"
                 if d > 1 else ""))


if __name__ == "__main__":
    main()
