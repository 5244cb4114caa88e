"""JAX compute kernels for the batched block codec.

Every op here is jit-compatible, operates on batches of padded blocks with
static shapes, and is validated element-for-element against the NumPy oracle
(``bzip2_tpu.oracle``).  int64 is deliberately avoided (multi-key
``lax.sort`` instead of packed keys; split 32-bit shifts in the bit packer)
so the kernels run under JAX's default 32-bit mode.
"""
