#!/usr/bin/env python
"""Microbenchmark: random-gather rounds on the device — the cost model
for a pointer-doubling (list-ranking) inverse BWT."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from bzip2_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    B, N = 8, 1 << 20
    rng = np.random.default_rng(0)

    def ranking(p, r):
        # full list-ranking: 20 doubling rounds, 2 gathers each
        def body(i, pr):
            p, r = pr
            r2 = r + jnp.take_along_axis(r, p, axis=1)
            p2 = jnp.take_along_axis(p, p, axis=1)
            return p2, r2
        return lax.fori_loop(0, 20, body, (p, r))

    f = jax.jit(ranking)
    args = []
    for _ in range(3):
        p = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
        r = np.ones((B, N), np.int32)
        args.append((jnp.asarray(p), jnp.asarray(r)))
    np.asarray(f(*args[0])[1][:, :1])
    for a in args:
        t0 = time.time()
        np.asarray(f(*a)[1][:, :1])
        print(f"20-round ranking (8x1M): {(time.time() - t0) * 1e3:.0f} ms",
              file=sys.stderr)

    # single gather cost
    def g1(p, r):
        def body(i, r):
            return jnp.take_along_axis(r, p, axis=1)
        return lax.fori_loop(0, 10, body, r)
    f1 = jax.jit(g1)
    np.asarray(f1(*args[0])[:, :1])
    for a in args:
        t0 = time.time()
        np.asarray(f1(*a)[:, :1])
        print(f"10 gathers (8x1M): {(time.time() - t0) * 1e3:.0f} ms",
              file=sys.stderr)


if __name__ == "__main__":
    main()
