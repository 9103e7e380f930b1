"""BP LDPC decoder: the hand-written CUDA kernels and their wrapper.

``decode`` is the counterpart of ``ldpc_3gpp_tpu/ops/decoder_pallas.py``'s
``decode``: for a CUDA tensor it launches the kernel of the schedule,
``csrc/ldpc_layered.cu`` or ``csrc/ldpc_flooding.cu`` (built at first use by
``kernels_build``), or raises; there is no fallback.  For a CPU tensor it
runs ``decode_plain``, the plain PyTorch version of the same function, which
the kernels are held equal to bit for bit (bits, ``parity_ok``,
``iterations``), sum-product included.

Ported variants of the TPU kernel: both schedules with all three check rules
(sum-product, min-sum, offset-min-sum), early termination and run-to-budget,
``channel_format`` 'cw'/'d', ``output_format`` 'cw'/'sys', any
``layer_order``, ``alpha_schedule``, and ``message_dtype`` 'float32' or (for
the min-sum family) 'bfloat16'.  The rule family and the message type are
compile-time instantiations; everything else is a run-time argument of one
binary per schedule that serves every base graph and lifting size.

Several small-Z codewords per block (the counterpart of the TPU kernel's
``lane_pack``): ``codewords_per_block`` = 0 chooses by
``auto_codewords_per_block``, 1 runs one block per codeword, P > 1 runs the
packed kernel of the schedule (the layered min-sum family at Z <= 32: the
warp kernel, ``warp_form``, each warp owning its codewords, persistent warps
taking codewords from a counter).  Packing changes no result.

The flooding kernels run each sweep as a message phase over every (row,
lane) item and a column phase over every (column, lane) item, with up to
1,024 threads per block and the messages in shared memory where they fit;
the packed one deals the items of the codewords still running over the whole
block.  The wrapper gives them their plans (``_one_block_plan``: rows and
columns dealt in descending degree, the messages in column planes;
``_cluster_plan``; the packed kernel's ``_column_plan``), their block size
(``flooding_threads``) and their layout (``flooding_layout``: one block per
codeword where that holds it, with the channel LLRs on chip where they still
fit, else a thread block cluster; ``packed_flooding_layout``: the P
codewords' messages on chip where they fit, else in a global scratch).  No
choice changes a result.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from .. import kernels_build
from ..spec.params import LDPCParams
from . import decoder_fast, decoder_layered
from .decoder import DecodeResult
from .decoder_fast import (
    ALGORITHMS,
    _row_plan,
    require_algorithm,
    resolve_message_dtype,
)
from .decoder_layered import _resolve_layer_order

# Large finite stand-in for the reference's +inf filler LLRs
# (NRLDPCDecoder.m:264): a filler minus a message stays finite in f32.  The
# kernels pin filler lanes to the same value (FILLER_LLR in csrc/ldpc_bp.cuh).
FILLER_LLR = 1e20

SCHEDULES = ("layered", "flooding")

# Kernel (source stem in csrc/) of each schedule.
KERNEL_NAMES = {"layered": "ldpc_layered", "flooding": "ldpc_flooding"}

# Number of launches of each kernel made by ``decode`` in this process, and
# the same split by the codewords per block and the layout each launch used
# (``launch_shape``): LAUNCHES_BY_P[(kernel, P, layout)].  Layout 2 or more
# is the flooding cluster kernel, a __global__ of its own.
LAUNCHES = {name: 0 for name in KERNEL_NAMES.values()}
LAUNCHES_BY_P = {}

# Argument types of ``ldpc_layered_decode``: seven pointers (llr, bits, ok,
# iters, scratch, edges, row_start), fourteen ints (ncw, Z, nc, nr, E, out_cols,
# d_input, fill_lo, fill_hi, iterations, early_termination, rule,
# bf16_messages, codewords_per_block), alpha, beta, alpha0, n0 and the stream.
DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
    + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
)
# ``ldpc_flooding_decode``: the same with the column plan (col_edges,
# col_start) and the cluster plan after row_start, and the layout, the block
# size (threads) and the cluster's slots_max after codewords_per_block.
FLOODING_DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 17
    + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
)
# Argument types of each kernel library's entries (``{name}_{entry}``).
ARGTYPES = {
    "ldpc_layered": {
        "decode": DECODE_ARGTYPES, "max_degree": [], "max_z": [],
        "max_shared_bytes": [],
        # rule, bf16_messages, Z, nc, nr, E, P
        "shared_bytes": [ctypes.c_int] * 7,
        # rule, bf16_messages, P, Z, nc, nr, E
        "blocks_per_sm": [ctypes.c_int] * 7,
        # rule, bf16_messages, Z, nc, nr, E, P
        "scratch_bytes": [ctypes.c_int] * 7,
    },
    "ldpc_flooding": {
        "decode": FLOODING_DECODE_ARGTYPES, "max_degree": [], "max_z": [],
        "max_shared_bytes": [],
        # Z, nc, nr, E, P, layout, slots_max
        "shared_bytes": [ctypes.c_int] * 7,
        # rule, bf16_messages, P, Z, nc, nr, E, layout, threads, slots_max
        "blocks_per_sm": [ctypes.c_int] * 10,
    },
}

# Limits of one block (MAX_THREADS in csrc/ldpc_bp.cuh: the layered and the
# packed kernels' lanes; FLOODING_MAX_THREADS in csrc/ldpc_flooding.cu; the
# dynamic shared memory a block of an H100 may opt in to).
MAX_BLOCK_THREADS = 384
FLOODING_MAX_THREADS = 1024
MAX_BLOCK_SHARED_BYTES = 232_448
# Shared memory of one H100 SM and what the hardware keeps back per block,
# for the flooding kernel's block size (as in tools/op_rates.py).
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024
# Where a launch keeps its messages: a global scratch (the layered kernels,
# and the packed flooding kernel where its P codewords' messages do not fit a
# block), one block's shared memory (the flooding kernels), or (2 to
# MAX_CLUSTER) the shared memory of a thread block cluster of that many
# blocks per codeword (three hold BG1 Z=384).
LAYOUT_SCRATCH, LAYOUT_ON_CHIP = 0, 1
MAX_CLUSTER = 3

# Argument types of the test entry ``ldpc_phi``: x, y, n, stream.
PHI_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

# The kernels' rule codes (RULE_* in csrc/ldpc_bp.cuh).
_RULE_CODES = {"min-sum": 0, "offset-min-sum": 1, "sum-product": 2}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_P.clear()


def supports(params: LDPCParams) -> bool:
    """Whether backend 'auto' sends this code to the kernels: every TS38.212
    lifting size fits one block (Z <= 384), and with several codewords per
    block the kernels beat the plain decoders on an H100 down to Z = 2
    (PERF.md, routing table), so no small Z is routed elsewhere."""
    return params.Z_c <= MAX_BLOCK_THREADS


def _align16(n: int) -> int:
    return -(-n // 16) * 16


# The warp form of the layered min-sum family (``ldpc_layered_warp_kernel``):
# P > 1 codewords per block at Z <= WARP_FORM_MAX_Z (``warp_form``), each
# warp holding ``warp_codewords`` of them outright with their totals and
# words in shared memory, a block at most what its threads
# (WARP_FORM_MAX_THREADS), its live lanes and its shared memory hold
# (``block_codewords``).  Sum-product and Z > 32 take the packed kernel.
WARP_FORM_MAX_Z = 32
WARP_FORM_MAX_THREADS = 512


def warp_codewords(Z: int, P: int) -> int:
    """Codewords one warp holds in the warp form: min(P, 32 // Z)."""
    return min(P, 32 // Z)


def warp_count(Z: int, P: int) -> int:
    """Warps of a warp-form block of ``P`` codewords."""
    return -(-P // warp_codewords(Z, P))


def warp_shared_bytes(Z: int, nc: int, nr: int, E: int, P: int, words: int) -> int:
    """A warp-form block's shared memory: the edge table (16 bytes an edge)
    and row records (8 bytes a row), then per warp its totals (nc x G*Z
    floats) and its words (``words`` 32-bit words per row and lane)."""
    lanes = warp_codewords(Z, P) * Z
    return (_align16(16 * E + 8 * nr)
            + warp_count(Z, P) * (_align16(4 * nc * lanes) + 4 * nr * words * lanes))


def _warp_form(Z: int, P: int, algorithm: str) -> bool:
    return algorithm != "sum-product" and P > 1 and Z <= WARP_FORM_MAX_Z


def warp_form(params: LDPCParams, P: int, algorithm: str = "min-sum") -> bool:
    """Whether a layered launch of ``P`` codewords per block runs the warp
    kernel: the min-sum family, P > 1, Z <= 32 (else the packed kernel, or
    the one-codeword kernels at P = 1)."""
    return _warp_form(params.Z_c, P, algorithm)


def warp_max_warps(Z: int, nc: int, nr: int, E: int, G: int, words: int) -> int:
    """The most warps of ``G`` codewords that one warp-form block holds:
    WARP_FORM_MAX_THREADS threads, MAX_BLOCK_THREADS live lanes and a
    block's shared memory over one warp's totals and words."""
    table = _align16(16 * E + 8 * nr)
    per_warp = warp_shared_bytes(Z, nc, nr, E, G, words) - table
    return min(WARP_FORM_MAX_THREADS // 32, MAX_BLOCK_THREADS // (G * Z),
               (MAX_BLOCK_SHARED_BYTES - table) // per_warp)


def _block_codewords(Z: int, nc: int, nr: int, E: int, P: int, algorithm: str,
                     message_dtype: str) -> int:
    if not _warp_form(Z, P, algorithm):
        return P
    G = warp_codewords(Z, P)
    words = COMPRESSED_WORDS[resolve_message_dtype(message_dtype, algorithm)]
    return min(P, G * warp_max_warps(Z, nc, nr, E, G, words))


def block_codewords(params: LDPCParams, P: int, algorithm: str = "min-sum",
                    message_dtype: str = "float32") -> int:
    """The codewords that one block holds when ``P`` are asked for (the
    source's ``block_codewords``): in the warp form at most what its warps
    hold (``warp_max_warps``; the warps are persistent, so P only sets how
    many share a block), else P."""
    return _block_codewords(params.Z_c, params.num_cols, params.num_rows,
                            len(params.edges[0]), P, algorithm, message_dtype)


def shared_bytes(schedule: str, Z: int, nc: int, nr: int, E: int, P: int = 1,
                 on_chip: bool = True, algorithm: str = "min-sum",
                 message_dtype: str = "float32") -> int:
    """Dynamic shared memory of one block for ``P`` codewords asked for: the
    formula of ``ldpc_*_shared_bytes`` in the CUDA sources.  Layered, the
    warp form (``warp_form``): ``warp_shared_bytes`` of the codewords the
    block holds (``block_codewords``).  Else layered: totals per
    codeword; edge table; row offsets; P > 1: a flag word per codeword.
    Flooding, one codeword per block: FLOODING_SHARED_BYTES, the totals, the
    E*Z messages and, where that still fits a block, the channel LLRs
    (float32; ``one_block_slots``), then the plan (``_one_block_plan``: an
    int4 per edge, an int2 per column, the row offsets and the planes'
    offsets); it may exceed what a block has: then ``flooding_layout`` takes
    a cluster.  Flooding, P > 1: FLOODING_PACKED_SHARED_BYTES, the totals
    per codeword (and the messages if ``on_chip``), row and column plans and
    their offsets, and four vote words per codeword and two per block (flags
    and live lists, by sweep)."""
    if schedule == "flooding":
        if P == 1:
            return _one_block_bytes(Z, nc, nr, E, one_block_slots(Z, nc, nr, E))
        return (_align16(P * (nc + (E if on_chip else 0)) * Z * 4) + E * 16
                + (nr + nc + 2) * 4 + P * 16 + 8)
    if _warp_form(Z, P, algorithm):
        return warp_shared_bytes(Z, nc, nr, E,
                                 _block_codewords(Z, nc, nr, E, P, algorithm, message_dtype),
                                 COMPRESSED_WORDS[resolve_message_dtype(message_dtype, algorithm)])
    return _align16(P * nc * Z * 4) + E * 16 + (nr + 1) * 4 + (P * 4 if P > 1 else 0)


# The densest column a one-codeword block's plan has room for
# (MAX_COLUMN_DEGREE in csrc/ldpc_flooding.cu; BG1's column 0 has 30 edges).
MAX_COLUMN_DEGREE = 31


def _one_block_bytes(Z: int, nc: int, nr: int, E: int, slots: int) -> int:
    """FLOODING_SHARED_BYTES: ``slots`` Z-lane float slots, the edge table
    (16 bytes an edge), the column table (8 bytes a column), the row offsets
    and the planes' offsets."""
    return (_align16(slots * Z * 4) + 16 * E + 8 * nc + 4 * (nr + 1)
            + 4 * (MAX_COLUMN_DEGREE + 1))


def one_block_slots(Z: int, nc: int, nr: int, E: int) -> int:
    """The Z-lane float slots of a one-codeword flooding block: the totals
    and the messages (nc + E), and the channel LLRs (nc more) where the block
    then still fits, so that the column phase reads them on chip."""
    slots = 2 * nc + E
    fits = _one_block_bytes(Z, nc, nr, E, slots) <= MAX_BLOCK_SHARED_BYTES
    return slots if fits else nc + E


# 32-bit words per (row, lane) of the layered min-sum family's compressed
# messages (RowWords in csrc/ldpc_bp.cuh): m1s, m2s and the meta word with
# float32 messages; m1s | m2s as bfloat16 bits, and meta, with bfloat16.
COMPRESSED_WORDS = {torch.float32: 3, torch.bfloat16: 2}


def scratch_shape(params: LDPCParams, n: int, schedule: str = "layered",
                  algorithm: str = "min-sum", message_dtype: str = "float32",
                  P: int = 1):
    """(shape, dtype) of the message scratch that ``decode`` gives a launch
    of ``n`` codewords with ``P`` codewords per block, or None where the
    launch keeps its messages on chip (the flooding kernels, but for a
    packed launch whose messages do not fit a block).  One entry per block
    of P codewords (the last block's share is whole): the layered min-sum
    family keeps each row's messages in compressed form, (blocks, num_rows,
    COMPRESSED_WORDS, P*Z) int32 words in processing order; layered
    sum-product one message per edge, (blocks, E, P*Z) float32; the packed
    flooding kernel one unrounded message per edge, (blocks, P, E, Z)
    float32.  The warp form: its codeword counter, (1,) int32 (its messages
    are on chip)."""
    dtype = resolve_message_dtype(message_dtype, algorithm)
    Z, E = params.Z_c, len(params.edges[0])
    blocks = -(-n // P)
    if schedule == "flooding":
        if P == 1 or packed_flooding_layout(params, P) == LAYOUT_ON_CHIP:
            return None
        return (blocks, P, E, Z), torch.float32
    if warp_form(params, P, algorithm):
        return (1,), torch.int32
    if algorithm != "sum-product":
        return (blocks, params.num_rows, COMPRESSED_WORDS[dtype], P * Z), torch.int32
    return (blocks, E, P * Z), dtype


def flooding_on_chip(params: LDPCParams) -> bool:
    """Whether totals, all messages and the plan of one codeword fit one
    block (BG2 Z <= 224, BG1 Z <= 144)."""
    Z, nc, nr, E = params.Z_c, params.num_cols, params.num_rows, len(params.edges[0])
    return _one_block_bytes(Z, nc, nr, E, nc + E) <= MAX_BLOCK_SHARED_BYTES


# Where a block of a cluster keeps a column's messages and its total, in the
# plan the cluster kernel takes (OWNER_SHIFT / OFFSET_MASK in
# csrc/ldpc_flooding.cu): the owning block's rank above OWNER_SHIFT, the
# offset in its shared memory below.
OWNER_SHIFT = 24
# The cluster plan's header: rows_lo and cols_lo, MAX_CLUSTER + 1 words each
# whatever the cluster's size; then the column table and the edge table,
# CLUSTER_TABLE_WORDS words an entry.
CLUSTER_TABLE_WORDS = 4


def _cluster_fixed_bytes(nc: int, nr: int, E: int) -> int:
    """The part of FLOODING_CLUSTER_SHARED_BYTES that does not depend on the
    split: the edge table and the column table (16 bytes an entry), the row
    offsets, the header and the vote words."""
    return 16 * E + 16 * nc + 4 * (nr + 1) + 64


def _cluster_slots_cap(params: LDPCParams) -> int:
    """The most Z-lane slots (a column's total, or one edge's messages) that
    one block of a cluster holds within MAX_BLOCK_SHARED_BYTES."""
    Z, nc, nr, E = params.Z_c, params.num_cols, params.num_rows, len(params.edges[0])
    room = MAX_BLOCK_SHARED_BYTES - _cluster_fixed_bytes(nc, nr, E)
    slots = room // (4 * Z)
    return slots if _align16(slots * Z * 4) <= room else slots - 1


@functools.lru_cache(maxsize=None)
def _cluster_split(params: LDPCParams, size: int) -> tuple:
    """How a cluster of ``size`` blocks shares one codeword.

    Rows: contiguous base rows of about E/size edges each (the message
    phase's work).  Columns: each column's total and all of its edges'
    messages live in one block, its owner, so that the column phase reads
    only its own block's shared memory; the message phase reads a column's
    total and an edge's message, and stores the new message, in the owner.
    A column goes to the block that holds most of its edges (ties to the
    block with the fewest slots so far), then columns move off any block
    above ``_cluster_slots_cap``, each time the move that adds the fewest
    remote edges (an edge whose row and column are in different blocks) per
    slot moved.  Returns (row_lo [size+1], owner per column, most slots of
    a block)."""
    _, row_start, _ = _graph_plan(params, tuple(range(params.num_rows)))
    E, nr, nc = int(row_start[-1]), params.num_rows, params.num_cols
    row_lo = [0]
    for q in range(1, size):
        target = q * E / size
        r = int(np.searchsorted(row_start, target))
        if r > 0 and target - row_start[r - 1] <= row_start[r] - target:
            r -= 1
        row_lo.append(min(max(r, row_lo[-1] + 1), nr - (size - q)))
    row_lo.append(nr)
    col_edges, col_start = _column_plan(params)
    block_of_row = np.searchsorted(np.asarray(row_lo[1:]), np.arange(nr), side="right")
    row_of_edge = np.repeat(np.arange(nr), np.diff(row_start))
    # per column: its edges in each block
    held = np.zeros((nc, size), dtype=np.int64)
    for c in range(nc):
        slots = col_edges[col_start[c]:col_start[c + 1], 0] // params.Z_c
        held[c] = np.bincount(block_of_row[row_of_edge[slots]], minlength=size)
    units = held.sum(1) + 1  # the total and one message per edge
    owner = np.zeros(nc, dtype=np.int64)
    load = np.zeros(size, dtype=np.int64)
    for c in sorted(range(nc), key=lambda c: (-units[c], c)):
        owner[c] = min(range(size), key=lambda q: (-held[c, q], load[q], q))
        load[owner[c]] += units[c]
    cap = _cluster_slots_cap(params)
    while load.max() > cap:
        src = int(load.argmax())
        moves = [((held[c, src] - held[c, q]) / units[c], -units[c], c, q)
                 for c in np.flatnonzero(owner == src) for q in range(size)
                 if q != src and load[q] + units[c] <= cap]
        if not moves:
            break  # this size does not fit; the layout rule takes a larger one
        _, _, c, q = min(moves)
        owner[c] = q
        load[src] -= units[c]
        load[q] += units[c]
    return np.asarray(row_lo, dtype=np.int32), owner.astype(np.int32), int(load.max())


@functools.lru_cache(maxsize=None)
def _cluster_plan(params: LDPCParams, size: int) -> np.ndarray:
    """The int32 plan the cluster kernel takes (``_cluster_split``'s split):

    - rows_lo [MAX_CLUSTER + 1], cols_lo [MAX_CLUSTER + 1]: each block's
      base rows and its range of the column table (past the cluster's size,
      nr and nc);
    - the column table [nc, 4], block by block, a block's columns ascending:
      (column, message offset, degree, 0), the offsets in Z-lane floats of
      the owner's shared memory, where its totals come first (the column's
      at its position in the table times Z) and then its columns' messages,
      one Z-lane slot per edge in ascending row order;
    - the edge table [E, 4] in row order: (owner << OWNER_SHIFT | offset of
      the column's total, shift, offset of the edge's message, 0)."""
    row_lo, owner, _ = _cluster_split(params, size)
    Z, nc, nr = params.Z_c, params.num_cols, params.num_rows
    edges, _, _ = _graph_plan(params, tuple(range(nr)))
    col_edges, col_start = _column_plan(params)
    head = np.zeros(2 * (MAX_CLUSTER + 1), dtype=np.int64)
    head[:size + 1] = row_lo
    head[size + 1:MAX_CLUSTER + 1] = nr
    cols = np.zeros((nc, CLUSTER_TABLE_WORDS), dtype=np.int64)
    edge_tab = np.zeros((len(edges), CLUSTER_TABLE_WORDS), dtype=np.int64)
    j = 0
    for q in range(size):
        head[MAX_CLUSTER + 1 + q] = j
        mine = np.flatnonzero(owner == q)
        msg = len(mine)  # the block's first message slot: after its totals
        for k, c in enumerate(mine):
            deg = int(col_start[c + 1] - col_start[c])
            cols[j] = (c, msg * Z, deg, 0)
            for i, slot in enumerate(col_edges[col_start[c]:col_start[c + 1], 0] // Z):
                edge_tab[slot] = ((q << OWNER_SHIFT) | k * Z, edges[slot, 1], (msg + i) * Z, 0)
            msg += deg
            j += 1
    head[MAX_CLUSTER + 1 + size:] = nc
    return np.concatenate([head, cols.ravel(), edge_tab.ravel()]).astype(np.int32)


def flooding_shared_bytes(params: LDPCParams, layout: int, P: int = 1) -> int:
    """Dynamic shared memory of one block of a flooding kernel in
    ``layout``: one codeword per block, FLOODING_SHARED_BYTES (the channel
    LLRs on chip where they fit), or for a cluster
    FLOODING_CLUSTER_SHARED_BYTES of csrc/ldpc_flooding.cu (the most slots a
    block of it holds, then the tables); P > 1,
    FLOODING_PACKED_SHARED_BYTES with the messages on chip (layout 1) or in
    a scratch (layout 0)."""
    Z, nc, nr, E = params.Z_c, params.num_cols, params.num_rows, len(params.edges[0])
    if P > 1:
        return shared_bytes("flooding", Z, nc, nr, E, P, on_chip=layout == LAYOUT_ON_CHIP)
    if layout >= 2:
        slots = _cluster_split(params, layout)[2]
        return _align16(slots * Z * 4) + _cluster_fixed_bytes(nc, nr, E)
    return shared_bytes("flooding", Z, nc, nr, E)


def flooding_layout(params: LDPCParams) -> int:
    """The layout rule of the one-codeword flooding kernel, on shape: one
    block per codeword where it holds totals, messages and plans
    (``flooding_on_chip``); above that a thread block cluster of the fewest
    blocks whose shares fit (2 up to BG1 Z=288 and BG2 Z=384, 3 at BG1
    Z=320 to 384).  On an H100 the cluster was faster at the sweep's launch
    than a global scratch for the messages (PERF.md §6)."""
    if flooding_on_chip(params):
        return LAYOUT_ON_CHIP
    for size in range(2, MAX_CLUSTER + 1):
        if flooding_shared_bytes(params, size) <= MAX_BLOCK_SHARED_BYTES:
            return size
    raise ValueError(f"no cluster of up to {MAX_CLUSTER} blocks holds Z={params.Z_c}")


def packed_flooding_layout(params: LDPCParams, P: int) -> int:
    """Where the packed flooding kernel keeps the messages of a block of
    ``P`` codewords: on chip where they fit the block with the totals and
    the plans, else in a global scratch."""
    fits = flooding_shared_bytes(params, LAYOUT_ON_CHIP, P) <= MAX_BLOCK_SHARED_BYTES
    return LAYOUT_ON_CHIP if fits else LAYOUT_SCRATCH


def flooding_threads(params: LDPCParams, n: int, layout=None, sms: int = 132,
                     P: int = 1) -> int:
    """Block size of a flooding kernel for ``n`` codewords, ``P`` per block,
    on ``sms`` SMs.  The kernels are held to 64 registers, so an SM runs at
    most FLOODING_MAX_THREADS of their threads; they are split, in whole
    warps, over the blocks that share an SM: as many as its shared memory
    holds, but no more than half the launch's blocks per SM, and never more
    threads than the column phase has items (P * num_cols * Z).  A launch
    whose blocks fit in two rounds lasts as long as its slowest codeword,
    which then has the SM to itself; a larger launch is faster with the SM
    shared (``tools/flooding_shapes.py`` on an H100, PERF.md §6)."""
    if layout is None:
        layout = flooding_layout(params) if P == 1 else packed_flooding_layout(params, P)
    size = max(layout, 1) if P == 1 else 1  # blocks per codeword, or per P
    smem = flooding_shared_bytes(params, layout, P)
    by_smem = SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES)
    blocks = max(1, min(by_smem, -(-max(-(-n // P), 1) * size // (2 * sms))))
    threads = FLOODING_MAX_THREADS // blocks // 32 * 32
    return max(32, min(threads, -(-(P * params.num_cols * params.Z_c) // 32) * 32))


def _fits(schedule: str, params: LDPCParams, P: int, algorithm: str = "min-sum",
          message_dtype: str = "float32") -> bool:
    """Whether P codewords per block fit: at most MAX_BLOCK_THREADS lanes in
    whole warps, and the shared memory of the launch's form (packed
    flooding: its smallest, messages in the scratch; layered: the warp form,
    which holds what fits of any P, or the packed kernel)."""
    if schedule == "flooding" and P == 1:
        return params.Z_c <= MAX_BLOCK_THREADS  # a cluster holds what a block does not
    E = len(params.edges[0])
    return (
        -(-(P * params.Z_c) // 32) * 32 <= MAX_BLOCK_THREADS
        and shared_bytes(schedule, params.Z_c, params.num_cols, params.num_rows, E, P,
                         on_chip=False, algorithm=algorithm,
                         message_dtype=message_dtype) <= MAX_BLOCK_SHARED_BYTES
    )


# The automatic choice of codewords per block, from tools/small_z.py's
# packing table of the warp form, taken twice (NVIDIA H100 80GB HBM3, 700 W;
# min-sum, float32 and bfloat16 messages, Z = 2, 5, 8, 13, 20, 26, 32, 256 to
# 16,384 codewords, 8 sweeps and a 50-sweep budget; PERF.md §6):
# - The min-sum family at Z <= 32 takes the warp form with as many warps per
#   SM as the launch fills: W = min(``warp_form_warps``, ceil(n / (sms * G)))
#   warps of G = 32 // Z codewords, P = G * W, but for one codeword per block
#   where P would be 1, at Z > 2 where the launch has at most two codewords
#   per SM (n <= 2 * sms: one codeword per block was ahead in 20 of the 24
#   rows at 256 codewords and Z >= 5, by up to 67 %; at Z=2 the warp form
#   was ahead by 9-19 %), and at Z=32 below two rounds of the warp form's
#   blocks (n < 2 * sms * W: one codeword per block already fills its warps
#   there; at 2,048 codewords the warp form was 8 % ahead to 30 % behind).
#   Everywhere else in both tables the rule was ahead of one codeword per
#   block in 146 of 148 rows: at 16,384 codewords by 7.3-9.8 times at Z=2,
#   3.1-3.4 times at Z=8, 16-18 % at Z=20, 11-14 % at Z=32.  The two rows
#   behind, each seen once: Z=8 at 2,048 codewords (45 %; 13 % ahead in the
#   other table) and Z=32 with bfloat16 messages at 4,096, 50 sweeps at
#   3.0 dB (26 %; 19 % ahead in the other).
# - Sum-product keeps the packed kernel and the rule it had: the largest of
#   PACK_CHOICES that keeps P*Z within PACK_MAX_LANES, fills the block's
#   warps better than one codeword does and leaves PACK_MIN_BLOCKS blocks.
#   PACK_MIN_BLOCKS: with 1,024 blocks left, launches lost up to 43 % under
#   early termination with a 50-iteration budget; with 4,096 the worst
#   measured loss was 7 % (min-sum, the packed kernel).
# Flooding never packs: its one-codeword kernel deals a codeword's items over
# the whole block, and in the small-Z tables it beat every P at every Z and
# batch (PERF.md §6).
PACK_MAX_LANES = 64
PACK_MIN_BLOCKS = 4096
PACK_CHOICES = (2, 4, 8, 16)


def _warp_fill(lanes: int) -> float:
    """Share of live lanes in the warps that ``lanes`` threads round up to."""
    return lanes / (-(-lanes // 32) * 32)


def warp_form_warps(params: LDPCParams, message_dtype: str = "float32") -> int:
    """The most warps of the warp form (32 // Z codewords each) that one
    block, and so one SM, holds (``warp_max_warps``)."""
    Z = params.Z_c
    words = COMPRESSED_WORDS[resolve_message_dtype(message_dtype, "min-sum")]
    return warp_max_warps(Z, params.num_cols, params.num_rows, len(params.edges[0]), 32 // Z,
                          words)


def auto_codewords_per_block(params: LDPCParams, n: int, schedule: str,
                             algorithm: str = "min-sum", message_dtype: str = "float32",
                             sms: int = 132) -> int:
    """Codewords per block for ``n`` codewords of this code on ``sms`` SMs
    (see above): 1 for flooding; the min-sum family at Z <= 32 the warp form
    that fills the SMs, but for the smallest launches and Z=32 below two
    rounds; sum-product the packed kernel's cuts; else 1."""
    Z = params.Z_c
    if schedule == "flooding":
        return 1
    if algorithm == "sum-product":
        best = 1
        for P in PACK_CHOICES:
            if (P * Z <= PACK_MAX_LANES and _warp_fill(P * Z) > _warp_fill(Z)
                    and -(-n // P) >= PACK_MIN_BLOCKS
                    and _fits(schedule, params, P, algorithm)):
                best = P
        return best
    W = warp_form_warps(params, message_dtype) if Z <= WARP_FORM_MAX_Z else 0
    if W == 0 or (Z > 2 and n <= 2 * sms) or (Z == 32 and n < 2 * sms * W):
        return 1
    G = 32 // Z
    P = G * min(W, max(1, -(-n // (sms * G))))
    return P if P > 1 else 1


def resolve_codewords_per_block(params: LDPCParams, n: int, schedule: str,
                                codewords_per_block: int, algorithm: str = "min-sum",
                                message_dtype: str = "float32", sms: int = 132) -> int:
    """0 -> the automatic choice; an explicit value is checked against the
    block's threads and shared memory and raises where it does not fit."""
    P = int(codewords_per_block)
    if P == 0:
        return auto_codewords_per_block(params, n, schedule, algorithm, message_dtype, sms)
    if P < 1 or not _fits(schedule, params, P, algorithm, message_dtype):
        raise ValueError(
            f"codewords_per_block={P} does not fit one block at Z={params.Z_c} "
            f"({schedule}): at most {MAX_BLOCK_THREADS} threads and "
            f"{MAX_BLOCK_SHARED_BYTES} bytes of shared memory"
        )
    return P


@functools.lru_cache(maxsize=None)
def _graph_plan(params: LDPCParams, row_seq) -> tuple:
    """Numpy plan of the kernels' graph arrays, rows in ``row_seq`` order.

    edges (E, 4) int32: [col*Z, shift, edge_id*Z, first] per edge in
    processing order, ``first`` = 1 where no earlier edge touches the
    column; row_start (nr+1,) int32 offsets into it; max row degree.
    """
    by_row, _ = _row_plan(params)
    Z = params.Z_c
    edges, row_start = [], [0]
    seen = set()
    for r in row_seq:
        for (e, c, s) in by_row[r]:
            edges.append((c * Z, s, e * Z, int(c not in seen)))
            seen.add(c)
        row_start.append(len(edges))
    assert len(seen) == params.num_cols  # every column has an edge
    max_deg = max(len(by_row[r]) for r in row_seq)
    return (
        np.asarray(edges, dtype=np.int32),
        np.asarray(row_start, dtype=np.int32),
        max_deg,
    )


@functools.lru_cache(maxsize=None)
def _column_plan(params: LDPCParams) -> tuple:
    """Numpy column plan of the packed flooding kernel.

    col_edges (E, 2) int32: [slot*Z, shift] of each column's edges in
    ascending row order, slot = the edge's position in the ascending-row
    ``_graph_plan`` (where the kernel keeps its messages); col_start (nc+1,)
    int32 offsets into it.  A column's first entry is its ``first`` edge.
    """
    edges, _, _ = _graph_plan(params, tuple(range(params.num_rows)))
    Z = params.Z_c
    cols = edges[:, 0] // Z
    # a stable sort by column keeps each column's edges in row order
    order = np.argsort(cols, kind="stable")
    col_edges = np.stack([order * Z, edges[order, 1]], axis=1).astype(np.int32)
    col_start = np.concatenate(
        [[0], np.cumsum(np.bincount(cols, minlength=params.num_cols))]).astype(np.int32)
    return col_edges, col_start


@functools.lru_cache(maxsize=None)
def _one_block_plan(params: LDPCParams) -> np.ndarray:
    """The int32 plan the one-codeword flooding kernel takes:

    - the edge table [E, 4] in the order the message phase deals the rows
      (descending degree, ties in ascending row order; each row's edges in
      the reference's order): (offset of the column's totals + shift, offset
      of the edge's message + shift, Z - shift, 0), offsets in Z-lane floats
      of the block's totals and messages;
    - the column table [nc, 2] in the order the column phase deals the
      columns (descending degree, ties ascending): (column, degree); a
      column's totals are at its position in this table times Z;
    - the row offsets [nr + 1] of the dealt rows in the edge table;
    - the planes' first slots [MAX_COLUMN_DEGREE + 1] (E*Z past the last
      plane): plane k holds the message of the k-th edge, in ascending row
      order, of every column of more than k edges, in the column table's
      order, so that edge k of the column at position j is at plane k +
      j*Z, lane by lane."""
    edges, row_start, _ = _graph_plan(params, tuple(range(params.num_rows)))
    Z, nc, E = params.Z_c, params.num_cols, len(edges)
    cols, shifts = edges[:, 0] // Z, edges[:, 1]
    row_deg, col_deg = np.diff(row_start), np.bincount(cols, minlength=nc)
    if col_deg.max() > MAX_COLUMN_DEGREE:
        raise ValueError(f"a column of {col_deg.max()} edges: at most {MAX_COLUMN_DEGREE}")
    col_order = np.argsort(-col_deg, kind="stable")
    position = np.empty(nc, dtype=np.int64)
    position[col_order] = np.arange(nc)
    planes = np.full(MAX_COLUMN_DEGREE + 1, E * Z, dtype=np.int64)
    planes[:col_deg.max() + 1] = Z * np.concatenate(
        [[0], np.cumsum([(col_deg > k).sum() for k in range(col_deg.max())])])
    # each edge's rank among its column's edges: the edges are in ascending
    # row order, so a running count per column
    rank = np.zeros(E, dtype=np.int64)
    seen = np.zeros(nc, dtype=np.int64)
    for e, c in enumerate(cols):
        rank[e], seen[c] = seen[c], seen[c] + 1
    row_order = np.argsort(-row_deg, kind="stable")
    dealt = np.concatenate([np.arange(row_start[r], row_start[r + 1]) for r in row_order])
    j = position[cols[dealt]]
    s = shifts[dealt].astype(np.int64)
    table = np.stack([j * Z + s, planes[rank[dealt]] + j * Z + s, Z - s, 0 * s], axis=1)
    col_table = np.stack([col_order, col_deg[col_order]], axis=1)
    dealt_start = np.concatenate([[0], np.cumsum(row_deg[row_order])])
    return np.concatenate([table.ravel(), col_table.ravel(), dealt_start, planes]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _graph_device(params: LDPCParams, row_seq, device: torch.device):
    """Device copies of the graph arrays, cached per (params, order, device)."""
    edges, row_start, _ = _graph_plan(params, row_seq)
    return (
        torch.from_numpy(edges).to(device).contiguous(),
        torch.from_numpy(row_start).to(device).contiguous(),
    )


@functools.lru_cache(maxsize=None)
def _flooding_device(params: LDPCParams, layout: int, P: int, device: torch.device):
    """Device copies of what the flooding kernels take beside the row plan:
    the column plan (the packed kernel's) and the plan of the one-codeword
    form, for one block (``_one_block_plan``) or a cluster
    (``_cluster_plan``); a placeholder word for the packed kernel."""
    if P > 1:
        plan = np.zeros(1, np.int32)
    else:
        plan = _cluster_plan(params, layout) if layout >= 2 else _one_block_plan(params)
    return tuple(torch.from_numpy(a).to(device).contiguous()
                 for a in (*_column_plan(params), plan))


def _block_slots(params: LDPCParams, layout: int, P: int = 1) -> int:
    """The Z-lane float slots a block of a one-codeword launch holds (one
    block: ``one_block_slots``; a cluster: the most a block of it holds), or
    0 for a packed launch."""
    if P > 1:
        return 0
    if layout >= 2:
        return _cluster_split(params, layout)[2]
    return one_block_slots(params.Z_c, params.num_cols, params.num_rows, len(params.edges[0]))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_shape(params: LDPCParams, n: int, schedule: str,
                 codewords_per_block: int = 0, sms: int = 132, algorithm: str = "min-sum",
                 message_dtype: str = "float32") -> dict:
    """How ``decode`` launches ``n`` codewords: codewords per block (what a
    block holds of those asked for, ``block_codewords``), threads per block
    and the layout of the messages (flooding: ``flooding_layout``,
    ``packed_flooding_layout``; layered: 1 for the warp form, its messages on
    chip, else 0, the scratch)."""
    P = resolve_codewords_per_block(params, n, schedule, codewords_per_block, algorithm,
                                    message_dtype, sms)
    if schedule == "flooding":
        layout = (flooding_layout(params) if P == 1
                  else packed_flooding_layout(params, P))
        threads = flooding_threads(params, n, layout, sms, P)
    elif warp_form(params, P, algorithm):
        P = block_codewords(params, P, algorithm, message_dtype)
        layout = LAYOUT_ON_CHIP
        threads = warp_count(params.Z_c, P) * 32
    else:
        layout = LAYOUT_SCRATCH
        threads = -(-(P * params.Z_c) // 32) * 32
    return dict(codewords_per_block=P, threads=threads, layout=layout)


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The built library of kernel ``name`` with its functions declared."""
    return declare(kernels_build.load(name), name)


def declare(lib, name: str):
    """``lib`` (a ctypes library of kernel ``name``) with its functions'
    argument and result types set."""
    for fn, argtypes in ARGTYPES[name].items():
        f = getattr(lib, f"{name}_{fn}")
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    if name == KERNEL_NAMES["flooding"]:
        lib.ldpc_phi.argtypes = PHI_ARGTYPES
        lib.ldpc_phi.restype = ctypes.c_int
    return lib


def blocks_per_sm(params: LDPCParams, schedule: str = "layered",
                  algorithm: str = "min-sum", message_dtype: str = "float32",
                  codewords_per_block: int = 1, n: int = 1) -> int:
    """Blocks of the kernel that ``decode`` would launch for these arguments
    and ``n`` codewords that one SM of the current CUDA device holds at a
    time (the occupancy the CUDA runtime reports for the built kernel)."""
    name = KERNEL_NAMES[schedule]
    dtype = resolve_message_dtype(message_dtype, algorithm)
    args = [_RULE_CODES[algorithm], int(dtype == torch.bfloat16),
            int(codewords_per_block), params.Z_c, params.num_cols,
            params.num_rows, len(params.edges[0])]
    if schedule == "flooding":
        shape = launch_shape(params, n, schedule, codewords_per_block,
                             _sm_count(torch.device("cuda", torch.cuda.current_device())),
                             algorithm, message_dtype)
        args += [shape["layout"], shape["threads"],
                 _block_slots(params, shape["layout"], shape["codewords_per_block"])]
    n = getattr(_library(name), name + "_blocks_per_sm")(*args)
    if n < 0:
        raise RuntimeError(f"{name}_blocks_per_sm failed: CUDA error {-n}")
    return n


def phi_on_device(x: torch.Tensor) -> torch.Tensor:
    """The kernels' ``phi`` device function on a float32 CUDA tensor: a test
    entry that holds it against ``ops.decoder._phi``."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError("phi_on_device needs a float32 CUDA tensor")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        lib = _library(KERNEL_NAMES["flooding"])
        with torch.cuda.device(x.device):
            err = lib.ldpc_phi(x.data_ptr(), y.data_ptr(), x.numel(),
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ldpc_phi launch failed: CUDA error {err}")
    return y


def _check_formats(params, llr, channel_format, output_format):
    if channel_format not in ("cw", "d"):
        raise ValueError(f"unsupported channel_format {channel_format!r}")
    if output_format not in ("cw", "sys"):
        raise ValueError(f"unsupported output_format {output_format!r}")
    nc, Z = params.num_cols, params.Z_c
    nci = nc - 2 if channel_format == "d" else nc
    if llr.shape[-1] != nci * Z:
        raise ValueError(
            f"expected {nci * Z} LLRs per codeword for channel_format="
            f"{channel_format!r}, got {llr.shape[-1]}"
        )
    out_cols = params.num_sys_cols if output_format == "sys" else nc
    return nci, out_cols


def _check_alpha_schedule(alpha_schedule, algorithm):
    if alpha_schedule is None:
        return None
    if algorithm != "min-sum":
        raise ValueError("alpha_schedule applies to min-sum only")
    return float(alpha_schedule[0]), int(alpha_schedule[1])


def _check_arguments(params, llr, algorithm, schedule, message_dtype,
                     channel_format, output_format, alpha_schedule):
    """The argument checks of ``decode``; returns (message dtype, input
    columns, output columns, normalized alpha schedule)."""
    require_algorithm(algorithm)
    if schedule not in SCHEDULES:
        raise ValueError(f"unsupported schedule {schedule}")
    dtype = resolve_message_dtype(message_dtype, algorithm)
    nci, out_cols = _check_formats(params, llr, channel_format, output_format)
    alpha_schedule = _check_alpha_schedule(alpha_schedule, algorithm)
    return dtype, nci, out_cols, alpha_schedule


def decode_plain(
    params: LDPCParams,
    llr: torch.Tensor,
    iterations: int = 50,
    algorithm: str = "min-sum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    schedule: str = "layered",
    message_dtype: str = "float32",
    layer_order="reversed",
    channel_format: str = "cw",
    output_format: str = "cw",
    alpha_schedule=None,
    codewords_per_block: int = 0,
) -> DecodeResult:
    """Plain PyTorch version of ``decode`` on the device of ``llr``.

    ``codewords_per_block`` is accepted and ignored: packing changes no
    result, so this is the plain version of the packed kernels too.

    Builds the full codeword LLRs ('d' input: 2Z punctured zeros prepended,
    the filler range of d pinned to ``FILLER_LLR``), runs
    ``ops.decoder_layered.decode`` or ``ops.decoder_fast.decode`` by
    ``schedule`` and cuts the bits to the 'sys' prefix.
    """
    _, _, out_cols, alpha_schedule = _check_arguments(
        params, llr, algorithm, schedule, message_dtype, channel_format,
        output_format, alpha_schedule)
    Z = params.Z_c
    llr = llr.to(torch.float32)
    if channel_format == "d":
        zeros2z = torch.zeros(
            llr.shape[:-1] + (2 * Z,), dtype=torch.float32, device=llr.device
        )
        llr = torch.cat([zeros2z, llr], dim=-1)
        lo, hi = params.filler_range_d
        if hi > lo:
            llr[..., 2 * Z + lo : 2 * Z + hi] = FILLER_LLR
    kw = dict(
        iterations=iterations, algorithm=algorithm, alpha=alpha, beta=beta,
        early_termination=early_termination, alpha_schedule=alpha_schedule,
        message_dtype=message_dtype,
    )
    if schedule == "layered":
        res = decoder_layered.decode(params, llr, layer_order=layer_order, **kw)
    else:
        res = decoder_fast.decode(params, llr, **kw)
    return DecodeResult(
        bits=res.bits[..., : out_cols * Z],
        parity_ok=res.parity_ok,
        iterations=res.iterations,
    )


@torch.no_grad()
def decode(
    params: LDPCParams,
    llr: torch.Tensor,
    iterations: int = 50,
    algorithm: str = "min-sum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    schedule: str = "layered",
    message_dtype: str = "float32",
    layer_order="reversed",
    channel_format: str = "cw",
    output_format: str = "cw",
    alpha_schedule=None,
    codewords_per_block: int = 0,
    *,
    _threads: int = 0,
    _lib=None,
) -> DecodeResult:
    """BP decode of (..., nci*Z) LLRs; CUDA tensors run the kernel.

    channel_format='cw' (default): ``llr`` is the full (..., num_cols*Z)
    codeword buffer — punctured 2Z zeros prepended and fillers already
    pinned by the caller.  channel_format='d': ``llr`` is the raw
    (..., (num_cols-2)*Z) rate-matching circular buffer (TS38.212 d, fillers
    NOT pinned); the kernel synthesizes the punctured zeros and pins the
    filler lanes while it loads, sparing the caller one full-buffer pass.

    output_format='cw' (default): ``bits`` covers the full num_cols*Z
    codeword.  output_format='sys': only the first num_sys_cols*Z = K
    systematic+filler positions (all the transport-block chain reads).

    schedule='layered' converges in about half the sweeps; 'flooding'
    reproduces the trajectory of ``ops.decoder_fast`` / MATLAB
    comm.LDPCDecoder (same rule, same syndrome-check points).

    message_dtype='bfloat16' (min-sum family only) stores the check messages
    in bfloat16; arithmetic stays float32 and messages are only rounded on
    store.  Sum-product is float32-only, so that it stays bit-exact.

    layer_order: 'reversed' (default), 'natural' or a permutation tuple;
    ignored by the flooding schedule, whose trajectory is order-invariant.
    alpha_schedule=(alpha0, n0) (min-sum only): alpha0 for the first n0
    update sweeps, ``alpha`` after.

    codewords_per_block: 0 (default) packs several small-Z codewords into
    one block by ``auto_codewords_per_block`` (from Z, the batch and the
    rule: the min-sum family at Z <= 32 takes the warp form but for the
    smallest launches, sum-product packs only launches of 8,192 codewords
    and more at Z <= 16);
    1 runs one block per codeword; P > 1 asks for P and raises where P*Z
    exceeds a block's threads or shared memory (the warp form's blocks hold
    what fits of them, ``block_codewords``).  Results do not depend on it.

    ``_threads`` (internal, for ``tools/flooding_shapes.py``,
    ``exp_bf16.py`` and ``exp_kernel_tiles.py``, which time the alternatives
    to the block-size rule): a flooding launch's threads
    per block instead of ``flooding_threads``'s; 0 keeps the rule.  Results
    do not depend on it.  ``_lib`` (internal, for
    ``tools/layered_probe.py`` and ``tools/flooding_probe.py``): a library of
    the schedule's kernel to launch instead of the built one (``declare``d),
    built from sources that size their blocks and scratch as this one does;
    None keeps the built one.

    A CUDA tensor launches the kernel on the current stream without
    synchronising (or raises); a CPU tensor runs ``decode_plain``.  The
    scratch for the messages is allocated here (``scratch_shape``): the
    layered min-sum family keeps three 32-bit words per row and lane (two
    with bfloat16 messages), 207 KiB per codeword at BG1 Z=384 (138 KiB in
    bfloat16); layered sum-product keeps E*Z messages per codeword (474 KiB
    in float32 at BG1 Z=384); the one-codeword flooding kernel keeps them in
    the shared memory of a block or of a cluster (``flooding_layout``) and
    has no scratch; the packed one keeps them in shared memory where the P
    codewords' fit a block, else E*Z float32 messages per codeword in a
    scratch (``packed_flooding_layout``).
    """
    dtype, nci, out_cols, alpha_schedule = _check_arguments(
        params, llr, algorithm, schedule, message_dtype, channel_format,
        output_format, alpha_schedule)
    if not llr.is_cuda:
        # an explicit value must fit, on any device (a CUDA launch checks it
        # in ``_launch_plan``)
        if codewords_per_block:
            resolve_codewords_per_block(params, 0, schedule, codewords_per_block, algorithm)
        return decode_plain(
            params, llr, iterations=iterations, algorithm=algorithm,
            alpha=alpha, beta=beta, early_termination=early_termination,
            schedule=schedule, message_dtype=message_dtype,
            layer_order=layer_order, channel_format=channel_format,
            output_format=output_format, alpha_schedule=alpha_schedule,
            codewords_per_block=codewords_per_block,
        )

    if iterations < 0:
        raise ValueError("iterations must not be negative")
    # flooding reads pre-sweep totals in every row: ascending row order,
    # which is also the order of its column sums
    row_seq = (_resolve_layer_order(params, layer_order)
               if schedule == "layered" else tuple(range(params.num_rows)))
    Z, nc, nr = params.Z_c, params.num_cols, params.num_rows
    E = len(params.edges[0])
    name = KERNEL_NAMES[schedule]
    lib = _library(name) if _lib is None else _lib
    dev = llr.device
    batch_shape = llr.shape[:-1]
    flat = llr.to(torch.float32).reshape(-1, nci * Z).contiguous()
    n = flat.shape[0]
    P, layout, spec, block = _launch_plan(
        params, row_seq, n, schedule, int(codewords_per_block), _sm_count(dev), algorithm,
        message_dtype, int(_threads), lib, dev)
    plans = _graph_device(params, row_seq, dev)
    if schedule == "flooding":
        plans += _flooding_device(params, layout, P, dev)
    bits = torch.empty((n, out_cols * Z), dtype=torch.int8, device=dev)
    flags = torch.empty((2, n), dtype=torch.int32, device=dev)  # parity_ok, iterations
    ok, iters = flags[0], flags[1]
    if n:
        # scratch for the check-to-variable messages; never zero-filled
        # (sweep 0 does not read it)
        scratch = None if spec is None else torch.empty(spec[0], dtype=spec[1], device=dev)
        lo, hi = params.filler_range_d if channel_format == "d" else (0, 0)
        a0, n0 = alpha_schedule if alpha_schedule is not None else (alpha, 0)
        with _on_device(dev):
            err = getattr(lib, name + "_decode")(
                flat.data_ptr(), bits.data_ptr(), ok.data_ptr(), iters.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                *(t.data_ptr() for t in plans), n, Z, nc, nr, E, out_cols,
                int(channel_format == "d"), lo, hi, int(iterations),
                int(bool(early_termination)), _RULE_CODES[algorithm],
                int(dtype == torch.bfloat16), *block,
                float(alpha), float(beta), float(a0), int(n0),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
        key = (name, P, layout)
        LAUNCHES_BY_P[key] = LAUNCHES_BY_P.get(key, 0) + 1
    return DecodeResult(
        bits=bits.reshape(batch_shape + (out_cols * Z,)),
        parity_ok=ok.to(torch.bool).reshape(batch_shape),
        iterations=iters.reshape(batch_shape),
    )


def _on_device(dev: torch.device):
    """A context that makes ``dev`` the current CUDA device, or a null one
    where it already is (entering one costs microseconds on every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.lru_cache(maxsize=4096)
def _launch_plan(params: LDPCParams, row_seq, n: int, schedule: str, codewords_per_block: int,
                 sms: int, algorithm: str, message_dtype: str, threads: int, lib,
                 dev: torch.device) -> tuple:
    """What ``decode`` launches for these arguments through ``lib`` on
    ``dev``, checked against the library once per shape: (codewords per
    block, layout, the scratch's (shape, dtype) or None, the launch's block
    arguments).  ``threads``: ``decode``'s ``_threads``.  Raises where the
    code exceeds the kernel's limits or the device's shared memory."""
    Z, nc, nr = params.Z_c, params.num_cols, params.num_rows
    E = len(params.edges[0])
    name = KERNEL_NAMES[schedule]
    max_deg = _graph_plan(params, row_seq)[2]
    if (max_deg > getattr(lib, name + "_max_degree")()
            or Z > getattr(lib, name + "_max_z")()):
        raise ValueError(
            f"kernel limits exceeded: row degree {max_deg}, Z={Z}"
        )
    shape = launch_shape(params, n, schedule, codewords_per_block, sms, algorithm,
                         message_dtype)
    P, layout = shape["codewords_per_block"], shape["layout"]
    flooding = schedule == "flooding"
    rule = _RULE_CODES[algorithm]
    bf16 = int(resolve_message_dtype(message_dtype, algorithm) == torch.bfloat16)
    if threads and flooding:
        shape["threads"] = threads  # the kernel checks it
    if flooding:
        need = lib.ldpc_flooding_shared_bytes(Z, nc, nr, E, P, layout,
                                              _block_slots(params, layout, P))
        assert need == flooding_shared_bytes(params, layout, P)
    else:
        need = lib.ldpc_layered_shared_bytes(rule, bf16, Z, nc, nr, E, P)
        assert need == shared_bytes(schedule, Z, nc, nr, E, P, algorithm=algorithm,
                                    message_dtype=message_dtype)
    with torch.cuda.device(dev):
        have = getattr(lib, name + "_max_shared_bytes")()
    if need > have:
        raise ValueError(
            f"{name} needs {need} bytes of shared memory per block for "
            f"num_cols={nc}, Z={Z}; the device allows {have}"
        )
    spec = scratch_shape(params, n, schedule, algorithm, message_dtype, P) if n else None
    if n and not flooding:
        share = lib.ldpc_layered_scratch_bytes(rule, bf16, Z, nc, nr, E, P)
        assert (share * -(-n // P) if layout == LAYOUT_SCRATCH else 4) == (
            int(np.prod(spec[0])) * torch.empty(0, dtype=spec[1]).element_size())
    if n:
        assert (spec is not None) == (not flooding or (layout == LAYOUT_SCRATCH and P > 1))
    block = ((P, layout, shape["threads"], _block_slots(params, layout, P))
             if flooding else (P,))
    return P, layout, spec, block
