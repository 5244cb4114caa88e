"""Multi-host block-parallel encode / member-grain decode
(``jax.distributed`` SPMD, DCN collectives via the platform backend).

The reference is strictly single-process; this layer supplies the
BASELINE configs #4/#5 shape: N hosts, per-host input shards, one
bit-exact output stream (SURVEY §2.3 "ICI/DCN collectives layer").

Encode pipeline (every process runs the same program):

1. **Split relay** — the exact global block decomposition is sequential
   at RLE1-segment granularity, but only the *split* is: process h splits
   ``carry + shard`` locally and relays the raw tail of its unclosed
   block to process h+1.  Blocks always close at segment boundaries
   ("segments flush whole", bzlib.c:276-308), so the carry starts in a
   clean RLE1 state and local re-splitting reproduces the single-host
   decomposition bit-exactly.  The relay moves O(one block) of raw bytes
   per hop; the expensive per-block work stays fully parallel.
2. **shard_map encode** — closed blocks form a global array sharded over
   the full device mesh (all hosts); every device runs the identical
   single-chip block encoder; per-block bit lengths are all-gathered in
   the program (parallel/mesh.py).
3. **Ordered gather + splice** — process 0 gathers the payload words
   (process_allgather over DCN) and bit-splices them in block order;
   combined CRC by the associative fold.

Decode: member-grain — each process decodes its round-robin share of the
stream's members (native runtime), outputs are gathered in order on
process 0.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None):
    """jax.distributed bring-up (CPU backend uses Gloo for cross-process
    collectives; GPUs use NCCL)."""
    import jax
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # non-CPU backends
        pass
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def _bcast_bytes(data: bytes, src: int) -> bytes:
    """Broadcast a variable-length byte string from process ``src``."""
    import jax
    from jax.experimental import multihost_utils as mhu

    is_src = jax.process_index() == src
    n = mhu.broadcast_one_to_all(
        np.array([len(data) if is_src else 0], np.int64), is_source=is_src)
    ln = int(n[0])
    buf = np.zeros(ln, np.uint8)
    if is_src:
        buf[:] = np.frombuffer(data, np.uint8)
    if ln:
        buf = mhu.broadcast_one_to_all(buf, is_source=is_src)
    return bytes(buf)


def compress_sharded(shard: bytes, level: int = 9) -> bytes | None:
    """Encode one per-host raw shard of a global input; returns the full
    .bz2 stream on process 0 (None elsewhere).  Bit-exact with the
    single-host encoder on the concatenated input."""
    import jax
    from jax.experimental import multihost_utils as mhu

    from .. import crc as _crc
    from .. import rle1 as _rle1
    from ..bitstream import BitWriter, splice
    from ..engine import _block_pad_size, _words_for
    from .mesh import build_sharded_encoder, make_mesh

    pid = jax.process_index()
    H = jax.process_count()

    # --- 1. split relay ------------------------------------------------
    my_blocks = []
    carry = b""
    for h in range(H):
        if pid == h:
            buf = carry + shard
            blocks = _rle1.encode_blocks(buf, level)
            if h == H - 1:
                my_blocks = blocks
                tail = b""
            else:
                # hold back the last block: its contents (and the EOS
                # epilogue) may change with the next shard's bytes
                my_blocks = blocks[:-1] if len(blocks) > 1 else []
                tail_from = (my_blocks[-1].raw_span[1] if my_blocks else 0)
                tail = buf[tail_from:]
        out_carry = tail if pid == h else b""
        if h < H - 1:
            carry = _bcast_bytes(out_carry, src=h)

    # --- 2. global sharded encode -------------------------------------
    counts = mhu.process_allgather(np.array([len(my_blocks)], np.int64))
    counts = counts.reshape(-1)
    max_b = int(counts.max()) if counts.size else 0
    if max_b == 0:
        total = 0
    else:
        total = int(counts.sum())
    N = _block_pad_size(level)
    W = _words_for(N)
    d = jax.device_count()
    # per-host padded to a common (max_b rounded to per-host device
    # multiple) so the global array shards evenly
    ld = max(1, d // H)
    Bh = max(-(-max_b // ld) * ld, ld)
    blocks_np = np.zeros((Bh, N), np.uint8)
    n_np = np.ones(Bh, np.int32)
    iu_np = np.zeros((Bh, 256), bool)
    iu_np[:, 0] = True
    crc_np = np.zeros(Bh, np.uint32)
    for j, blk in enumerate(my_blocks):
        blocks_np[j, :blk.data.size] = blk.data
        n_np[j] = blk.data.size
        iu_np[j] = blk.in_use
        crc_np[j] = blk.crc

    mesh = make_mesh()

    def g(x):
        spec = jax.sharding.PartitionSpec(
            *(["blocks"] + [None] * (x.ndim - 1)))
        sh = jax.sharding.NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(sh, x)

    fn = build_sharded_encoder(mesh, W)
    words, nbits = fn(g(blocks_np), g(n_np), g(iu_np), g(crc_np))

    # --- 3. ordered gather + splice on process 0 ----------------------
    words_all = mhu.process_allgather(words, tiled=True)   # (H*Bh, W)
    nbits_all = np.asarray(nbits)                          # replicated
    crcs_all = mhu.process_allgather(crc_np).reshape(-1)
    if pid != 0:
        return None
    wr = BitWriter()
    for v in (C.HDR_B, C.HDR_Z, C.HDR_h, C.HDR_0 + level):
        wr.write(v, 8)
    parts = [wr.getvalue()]
    block_crcs = []
    for h in range(H):
        for j in range(int(counts[h])):
            k = h * Bh + j
            nbit = int(nbits_all[k])
            payload = np.asarray(words_all[k][: (nbit + 31) // 32])
            by = payload.byteswap().view(np.uint8)
            parts.append((by[: (nbit + 7) // 8], nbit))
            block_crcs.append(int(crcs_all[k]))
    eos = BitWriter()
    eos.write(C.EOS_MAGIC, 48)
    eos.write(_crc.combine_block_crcs(block_crcs), 32)
    parts.append(eos.getvalue())
    return splice(parts)[0].tobytes()


def decompress_members(stream: bytes, backend: str = "native") -> bytes | None:
    """Member-grain multi-host decode: every process decodes its
    round-robin share of the concatenated stream's members; process 0
    returns the full output (None elsewhere).

    backend="device" decodes each local member's blocks on the process's
    local device mesh (parallel/mesh.py sharded decoder — block-DP inside
    the member, member-DP across hosts: BASELINE config #5); "native"
    uses the host runtime."""
    import jax

    from .. import native
    from .decode import find_member_offsets

    pid = jax.process_index()
    H = jax.process_count()
    starts = find_member_offsets(stream)
    offs = [(s, e) for s, e in zip(starts, starts[1:] + [len(stream)])]
    mesh = None
    if backend == "device":
        from .mesh import decode_blocks_sharded, make_mesh
        mesh = make_mesh(jax.local_devices())
    outs = {}
    for i, (start, end) in enumerate(offs):
        if i % H == pid:
            if mesh is not None:
                try:
                    outs[i] = decode_blocks_sharded(mesh, stream[start:end])
                    continue
                except ValueError:
                    pass  # randomised/malformed member: host decode below
            out, _, rc = native.decompress(stream[start:end])
            if out is None:
                raise ValueError(f"member {i} corrupt (rc={rc})")
            outs[i] = out
    # gather member outputs in order
    chunks = []
    for i in range(len(offs)):
        src = i % H
        chunks.append(_bcast_bytes(outs.get(i, b""), src=src))
    return b"".join(chunks) if pid == 0 else None
