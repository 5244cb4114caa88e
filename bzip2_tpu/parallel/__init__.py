"""Multi-chip / multi-host scaling layer.

bzip2 blocks are fully independent (48-bit delimiters, per-block CRCs —
reference manual "Each block is handled independently"), so the natural
device mapping is pure data parallelism over a 1-D device mesh: each device encodes
a shard of blocks with the same jitted program, per-block bit lengths are
all-gathered (small) so every participant can compute final splice offsets,
and the host performs the ordered bit-granular concatenation.
"""
