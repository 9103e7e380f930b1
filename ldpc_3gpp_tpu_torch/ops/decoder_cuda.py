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
packed kernel of the schedule.  Packing changes no result.

The flooding kernels run each sweep as a message phase over every (row,
lane) item and a column phase over every (column, lane) item, with up to
1,024 threads per block and the messages in shared memory where they fit;
the packed one deals the items of the codewords still running over the whole
block.  The wrapper gives them the column plan (``_column_plan``), their
block size (``flooding_threads``) and their layout (``flooding_layout``: one
block per codeword where that holds it, else a thread block cluster;
``packed_flooding_layout``: the P codewords' messages on chip where they fit,
else in a global scratch).  No choice changes a result.
"""
from __future__ import annotations

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
# col_start) and the cluster split (splits) after row_start, and the layout,
# the block size (threads) and the cluster's cols_max and edges_max after
# codewords_per_block.
FLOODING_DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 18
    + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
)
# Argument types of each kernel library's entries (``{name}_{entry}``).
ARGTYPES = {
    "ldpc_layered": {
        "decode": DECODE_ARGTYPES, "max_degree": [], "max_z": [],
        "max_shared_bytes": [],
        "shared_bytes": [ctypes.c_int] * 5,  # Z, nc, nr, E, P
        # rule, bf16_messages, P, Z, nc, nr, E
        "blocks_per_sm": [ctypes.c_int] * 7,
        "scratch_bytes": [ctypes.c_int] * 6,  # rule, bf16_messages, Z, nr, E, P
    },
    "ldpc_flooding": {
        "decode": FLOODING_DECODE_ARGTYPES, "max_degree": [], "max_z": [],
        "max_shared_bytes": [],
        # Z, nc, nr, E, P, layout, cols_max, edges_max
        "shared_bytes": [ctypes.c_int] * 8,
        # rule, bf16_messages, P, Z, nc, nr, E, layout, threads, cols_max,
        # edges_max
        "blocks_per_sm": [ctypes.c_int] * 11,
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


def shared_bytes(schedule: str, Z: int, nc: int, nr: int, E: int, P: int = 1,
                 on_chip: bool = True) -> int:
    """Dynamic shared memory of one block of ``P`` codewords: the formula of
    ``ldpc_*_shared_bytes`` in the CUDA sources.  Layered: totals per
    codeword; edge table; row offsets; P > 1: a flag word per codeword.
    Flooding, one codeword per block: FLOODING_SHARED_BYTES, the totals and
    the E*Z messages (float32), row and column plans and their offsets (it
    may exceed what a block has: then ``flooding_layout`` takes a cluster).
    Flooding, P > 1: FLOODING_PACKED_SHARED_BYTES, the same per codeword
    (without the messages unless ``on_chip``) and four vote words per
    codeword and two per block (flags and live lists, by sweep)."""
    if schedule == "flooding":
        if P == 1:
            return _align16((nc + E) * Z * 4) + E * 16 + (nr + nc + 2) * 4
        return (_align16(P * (nc + (E if on_chip else 0)) * Z * 4) + E * 16
                + (nr + nc + 2) * 4 + P * 16 + 8)
    return _align16(P * nc * Z * 4) + E * 16 + (nr + 1) * 4 + (P * 4 if P > 1 else 0)


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
    float32."""
    dtype = resolve_message_dtype(message_dtype, algorithm)
    Z, E = params.Z_c, len(params.edges[0])
    blocks = -(-n // P)
    if schedule == "flooding":
        if P == 1 or packed_flooding_layout(params, P) == LAYOUT_ON_CHIP:
            return None
        return (blocks, P, E, Z), torch.float32
    if algorithm != "sum-product":
        return (blocks, params.num_rows, COMPRESSED_WORDS[dtype], P * Z), torch.int32
    return (blocks, E, P * Z), dtype


def flooding_on_chip(params: LDPCParams) -> bool:
    """Whether totals, all messages and the plans of one codeword fit one
    block (BG2 Z <= 224, BG1 Z <= 144)."""
    return shared_bytes("flooding", params.Z_c, params.num_cols, params.num_rows,
                        len(params.edges[0])) <= MAX_BLOCK_SHARED_BYTES


@functools.lru_cache(maxsize=None)
def _cluster_split(params: LDPCParams, size: int) -> tuple:
    """How a cluster of ``size`` blocks shares one codeword: contiguous base
    rows of about E/size edges each (their messages) and contiguous columns
    of about num_cols/size each (their totals).  Returns (splits int32
    [row_lo[0..size], col_lo[0..size]], most columns, most edges of a
    block)."""
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
    col_lo = [round(q * nc / size) for q in range(size + 1)]
    edges = [int(row_start[row_lo[q + 1]] - row_start[row_lo[q]]) for q in range(size)]
    return (np.asarray(row_lo + col_lo, dtype=np.int32),
            max(np.diff(col_lo).tolist()), max(edges))


def flooding_shared_bytes(params: LDPCParams, layout: int, P: int = 1) -> int:
    """Dynamic shared memory of one block of a flooding kernel in
    ``layout``: one codeword per block, FLOODING_SHARED_BYTES, or for a
    cluster FLOODING_CLUSTER_SHARED_BYTES of csrc/ldpc_flooding.cu; P > 1,
    FLOODING_PACKED_SHARED_BYTES with the messages on chip (layout 1) or in
    a scratch (layout 0)."""
    Z, nc, nr, E = params.Z_c, params.num_cols, params.num_rows, len(params.edges[0])
    if P > 1:
        return shared_bytes("flooding", Z, nc, nr, E, P, on_chip=layout == LAYOUT_ON_CHIP)
    if layout >= 2:
        _, cols_max, edges_max = _cluster_split(params, layout)
        return (_align16(cols_max * Z * 4) + _align16(edges_max * Z * 4) + E * 16
                + (nr + nc + 2) * 4 + 64)
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


def _fits(schedule: str, params: LDPCParams, P: int) -> bool:
    """Whether P codewords per block fit: at most MAX_BLOCK_THREADS lanes in
    whole warps, and the shared memory of the smallest form (packed
    flooding: messages in the scratch)."""
    if schedule == "flooding" and P == 1:
        return params.Z_c <= MAX_BLOCK_THREADS  # a cluster holds what a block does not
    E = len(params.edges[0])
    return (
        -(-(P * params.Z_c) // 32) * 32 <= MAX_BLOCK_THREADS
        and shared_bytes(schedule, params.Z_c, params.num_cols, params.num_rows, E, P,
                         on_chip=False) <= MAX_BLOCK_SHARED_BYTES
    )


# The automatic choice of codewords per block, from the small-Z tables measured
# on an H100 (PERF.md; tools/small_z.py).  Two cuts, both read off the tables:
# - PACK_MAX_LANES: a packed block is slower per sweep than a one-codeword
#   block and lasts as long as its slowest codeword; above 64 lanes per block
#   packing moved no measured case by more than 12 % either way.
# - PACK_MIN_BLOCKS: the card holds 18 to 32 small-Z blocks per SM, so a launch
#   gains only where blocks are left over after packing.  With 1,024 blocks
#   left, launches lost up to 43 % under early termination with a 50-iteration
#   budget (the launch lasts as long as its stragglers' blocks); with 4,096
#   left the worst measured loss is 7 % and the largest gain 2.6 times.
# The sweeps' default calls (256 to 2,048 codewords) are below the floor and
# run one codeword per block; an explicit ``codewords_per_block`` packs them.
# Flooding never packs: its one-codeword kernel deals a codeword's items over
# the whole block, and in the small-Z tables it beat every P at every Z and
# batch (PERF.md §6).
PACK_MAX_LANES = 64
PACK_MIN_BLOCKS = 4096
PACK_CHOICES = (2, 4, 8, 16)


def _warp_fill(lanes: int) -> float:
    """Share of live lanes in the warps that ``lanes`` threads round up to."""
    return lanes / (-(-lanes // 32) * 32)


def auto_codewords_per_block(params: LDPCParams, n: int, schedule: str) -> int:
    """Codewords per block for ``n`` codewords of this code: 1 for flooding;
    layered: the largest of ``PACK_CHOICES`` that keeps P*Z within
    ``PACK_MAX_LANES``, fills the block's warps better than one codeword
    does, leaves at least ``PACK_MIN_BLOCKS`` blocks and fits a block's
    threads and shared memory; else 1."""
    Z = params.Z_c
    best = 1
    if schedule == "flooding":
        return best
    for P in PACK_CHOICES:
        if (P * Z <= PACK_MAX_LANES and _warp_fill(P * Z) > _warp_fill(Z)
                and -(-n // P) >= PACK_MIN_BLOCKS and _fits(schedule, params, P)):
            best = P
    return best


def resolve_codewords_per_block(params: LDPCParams, n: int, schedule: str,
                                codewords_per_block: int) -> int:
    """0 -> the automatic choice; an explicit value is checked against the
    block's threads and shared memory and raises where it does not fit."""
    P = int(codewords_per_block)
    if P == 0:
        return auto_codewords_per_block(params, n, schedule)
    if P < 1 or not _fits(schedule, params, P):
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
    """Numpy column plan of the one-codeword flooding kernel.

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
def _graph_device(params: LDPCParams, row_seq, device: torch.device):
    """Device copies of the graph arrays, cached per (params, order, device)."""
    edges, row_start, _ = _graph_plan(params, row_seq)
    return (
        torch.from_numpy(edges).to(device).contiguous(),
        torch.from_numpy(row_start).to(device).contiguous(),
    )


@functools.lru_cache(maxsize=None)
def _flooding_device(params: LDPCParams, layout: int, device: torch.device):
    """Device copies of what the flooding kernels take beside the row plan:
    the column plan and the cluster split (a placeholder word without a
    cluster)."""
    splits = _cluster_split(params, layout)[0] if layout >= 2 else np.zeros(1, np.int32)
    return tuple(torch.from_numpy(a).to(device).contiguous()
                 for a in (*_column_plan(params), splits))


def _cluster_sizes(params: LDPCParams, layout: int) -> tuple:
    """(most columns, most edges) of a block of the layout's cluster, or
    (0, 0) without one."""
    return _cluster_split(params, layout)[1:] if layout >= 2 else (0, 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_shape(params: LDPCParams, n: int, schedule: str,
                 codewords_per_block: int = 0, sms: int = 132) -> dict:
    """How ``decode`` launches ``n`` codewords: codewords per block, threads
    per block and, for flooding, the layout of the messages
    (``flooding_layout``, ``packed_flooding_layout``; layered: 0)."""
    P = resolve_codewords_per_block(params, n, schedule, codewords_per_block)
    if schedule == "flooding":
        layout = (flooding_layout(params) if P == 1
                  else packed_flooding_layout(params, P))
        threads = flooding_threads(params, n, layout, sms, P)
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
                             _sm_count(torch.device("cuda", torch.cuda.current_device())))
        args += [shape["layout"], shape["threads"], *_cluster_sizes(params, shape["layout"])]
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
    one block by ``auto_codewords_per_block`` (from Z and the batch: only
    launches of 8,192 codewords and more are packed); 1 runs one block per
    codeword; P > 1 asks for P and raises where P*Z exceeds a block's
    threads or shared memory.  Results do not depend on it.

    ``_threads`` (internal, for ``tools/flooding_shapes.py``, which times
    the alternatives to the block-size rule): a flooding launch's threads
    per block instead of ``flooding_threads``'s; 0 keeps the rule.  Results
    do not depend on it.  ``_lib`` (internal, for
    ``tools/layered_probe.py``): a library of the schedule's kernel to launch
    instead of the built one (``declare``d); None keeps the built one.

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
    if codewords_per_block:  # an explicit value must fit, on any device
        resolve_codewords_per_block(params, 0, schedule, codewords_per_block)
    if not llr.is_cuda:
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
    max_deg = _graph_plan(params, row_seq)[2]
    if (max_deg > getattr(lib, name + "_max_degree")()
            or Z > getattr(lib, name + "_max_z")()):
        raise ValueError(
            f"kernel limits exceeded: row degree {max_deg}, Z={Z}"
        )
    dev = llr.device
    batch_shape = llr.shape[:-1]
    flat = llr.to(torch.float32).reshape(-1, nci * Z).contiguous()
    n = flat.shape[0]
    shape = launch_shape(params, n, schedule, codewords_per_block, _sm_count(dev))
    P, layout = shape["codewords_per_block"], shape["layout"]
    flooding = schedule == "flooding"
    if _threads and flooding:
        shape["threads"] = int(_threads)  # the kernel checks it
    if flooding:
        cluster = _cluster_sizes(params, layout)
        need = lib.ldpc_flooding_shared_bytes(Z, nc, nr, E, P, layout, *cluster)
        assert need == flooding_shared_bytes(params, layout, P)
    else:
        need = lib.ldpc_layered_shared_bytes(Z, nc, nr, E, P)
        assert need == shared_bytes(schedule, Z, nc, nr, E, P)
    with torch.cuda.device(dev):
        have = getattr(lib, name + "_max_shared_bytes")()
    if need > have:
        raise ValueError(
            f"{name} needs {need} bytes of shared memory per block for "
            f"num_cols={nc}, Z={Z}; the device allows {have}"
        )
    plans = _graph_device(params, row_seq, dev)
    if flooding:
        plans += _flooding_device(params, layout, dev)
    bits = torch.empty((n, out_cols * Z), dtype=torch.int8, device=dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    iters = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        # scratch for the check-to-variable messages; never zero-filled
        # (sweep 0 does not read it)
        spec = scratch_shape(params, n, schedule, algorithm, message_dtype, P)
        scratch = None if spec is None else torch.empty(spec[0], dtype=spec[1], device=dev)
        if scratch is not None and not flooding:
            share = lib.ldpc_layered_scratch_bytes(
                _RULE_CODES[algorithm], int(dtype == torch.bfloat16), Z, nr, E, P)
            assert share * spec[0][0] == scratch.numel() * scratch.element_size()
        assert (scratch is not None) == (layout == LAYOUT_SCRATCH and (P > 1 or not flooding))
        lo, hi = params.filler_range_d if channel_format == "d" else (0, 0)
        a0, n0 = alpha_schedule if alpha_schedule is not None else (alpha, 0)
        block = ([P, layout, shape["threads"], *_cluster_sizes(params, layout)]
                 if flooding else [P])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, name + "_decode")(
                flat.data_ptr(), bits.data_ptr(), ok.data_ptr(), iters.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                *(t.data_ptr() for t in plans), n, Z, nc, nr, E, out_cols,
                int(channel_format == "d"), lo, hi, int(iterations),
                int(bool(early_termination)), _RULE_CODES[algorithm],
                int(dtype == torch.bfloat16), *block,
                float(alpha), float(beta), float(a0), int(n0), stream,
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
