"""Layered BP LDPC decoder: the hand-written CUDA kernel and its wrapper.

``decode`` is the counterpart of ``ldpc_3gpp_tpu/ops/decoder_pallas.py``'s
``decode`` for the layered schedule: for a CUDA tensor it launches
``csrc/ldpc_layered.cu`` (built at first use by ``kernels_build``) or raises;
there is no fallback.  For a CPU tensor it runs ``decode_plain``, the plain
PyTorch version of the same function, which the kernel is held equal to bit
for bit (bits, ``parity_ok``, ``iterations``).

Ported variants of the TPU kernel: layered min-sum and offset-min-sum, f32
messages, early termination and run-to-budget, ``channel_format`` 'cw'/'d',
``output_format`` 'cw'/'sys', any ``layer_order``, ``alpha_schedule`` — all
run-time arguments of one compiled kernel that serves every base graph and
lifting size.  Still to port (ROADMAP.md queue B): layered sum-product, the
flooding schedule, bfloat16 messages, several small-Z codewords per block.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels_build
from ..spec.params import LDPCParams
from . import decoder_layered
from .decoder import DecodeResult
from .decoder_fast import _row_plan
from .decoder_layered import ALGORITHMS, _resolve_layer_order, require_algorithm

# Large finite stand-in for the reference's +inf filler LLRs
# (NRLDPCDecoder.m:264): a filler minus a message stays finite in f32.  The
# kernel pins filler lanes to the same value (FILLER_LLR in the .cu source).
FILLER_LLR = 1e20

KERNEL_NAME = "ldpc_layered"

# Number of kernel launches made by ``decode`` in this process.
LAUNCHES = 0

# Argument types of ``ldpc_layered_decode`` in csrc/ldpc_layered.cu: seven
# pointers (llr, bits, ok, iters, c2v, edges, row_start), twelve ints (ncw, Z,
# nc, nr, E, out_cols, d_input, fill_lo, fill_hi, iterations,
# early_termination, offset_rule), alpha, beta, alpha0, n0 and the stream.
DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
    + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
)


def supports(params: LDPCParams) -> bool:
    """Whether the kernel takes this code: every TS38.212 lifting size fits
    one block (Z <= 384).  Routing very small Z elsewhere is undecided."""
    return params.Z_c <= 384


@functools.lru_cache(maxsize=None)
def _graph_plan(params: LDPCParams, row_seq) -> tuple:
    """Numpy plan of the kernel's graph arrays, rows in ``row_seq`` order.

    edges (E, 4) int32: [col*Z, shift, edge_id*Z, 0] per edge in processing
    order; row_start (nr+1,) int32 offsets into it; max row degree.
    """
    by_row, _ = _row_plan(params)
    Z = params.Z_c
    edges, row_start = [], [0]
    for r in row_seq:
        for (e, c, s) in by_row[r]:
            edges.append((c * Z, s, e * Z, 0))
        row_start.append(len(edges))
    max_deg = max(len(by_row[r]) for r in row_seq)
    return (
        np.asarray(edges, dtype=np.int32),
        np.asarray(row_start, dtype=np.int32),
        max_deg,
    )


@functools.lru_cache(maxsize=None)
def _graph_device(params: LDPCParams, row_seq, device: torch.device):
    """Device copies of the graph arrays, cached per (params, order, device)."""
    edges, row_start, _ = _graph_plan(params, row_seq)
    return (
        torch.from_numpy(edges).to(device).contiguous(),
        torch.from_numpy(row_start).to(device).contiguous(),
    )


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels_build.load(KERNEL_NAME)
    lib.ldpc_layered_decode.argtypes = DECODE_ARGTYPES
    lib.ldpc_layered_decode.restype = ctypes.c_int
    lib.ldpc_layered_max_degree.argtypes = []
    lib.ldpc_layered_max_degree.restype = ctypes.c_int
    lib.ldpc_layered_max_z.argtypes = []
    lib.ldpc_layered_max_z.restype = ctypes.c_int
    return lib


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


def decode_plain(
    params: LDPCParams,
    llr: torch.Tensor,
    iterations: int = 50,
    algorithm: str = "min-sum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    layer_order="reversed",
    channel_format: str = "cw",
    output_format: str = "cw",
    alpha_schedule=None,
) -> DecodeResult:
    """Plain PyTorch version of ``decode`` on the device of ``llr``.

    Builds the full codeword LLRs ('d' input: 2Z punctured zeros prepended,
    the filler range of d pinned to ``FILLER_LLR``), runs
    ``ops.decoder_layered.decode`` and cuts the bits to the 'sys' prefix.
    """
    _, out_cols = _check_formats(params, llr, channel_format, output_format)
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
    res = decoder_layered.decode(
        params, llr, iterations=iterations, algorithm=algorithm, alpha=alpha,
        beta=beta, early_termination=early_termination,
        layer_order=layer_order, alpha_schedule=alpha_schedule,
    )
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
    layer_order="reversed",
    channel_format: str = "cw",
    output_format: str = "cw",
    alpha_schedule=None,
) -> DecodeResult:
    """Layered BP decode of (..., nci*Z) LLRs; CUDA tensors run the kernel.

    channel_format='cw' (default): ``llr`` is the full (..., num_cols*Z)
    codeword buffer — punctured 2Z zeros prepended and fillers already
    pinned by the caller.  channel_format='d': ``llr`` is the raw
    (..., (num_cols-2)*Z) rate-matching circular buffer (TS38.212 d, fillers
    NOT pinned); the kernel synthesizes the punctured zeros and pins the
    filler lanes while it loads, sparing the caller one full-buffer pass.

    output_format='cw' (default): ``bits`` covers the full num_cols*Z
    codeword.  output_format='sys': only the first num_sys_cols*Z = K
    systematic+filler positions (all the transport-block chain reads).

    layer_order: 'reversed' (default), 'natural' or a permutation tuple.
    alpha_schedule=(alpha0, n0) (min-sum only): alpha0 for the first n0
    update sweeps, ``alpha`` after.

    A CUDA tensor launches the kernel on the current stream without
    synchronising (or raises); a CPU tensor runs ``decode_plain``.  The
    kernel keeps the per-edge messages in a scratch tensor of E*Z*4 bytes
    per codeword (474 KiB at BG1 Z=384), allocated here.
    """
    global LAUNCHES
    require_algorithm(algorithm)
    alpha_schedule = _check_alpha_schedule(alpha_schedule, algorithm)
    nci, out_cols = _check_formats(params, llr, channel_format, output_format)
    if not llr.is_cuda:
        return decode_plain(
            params, llr, iterations=iterations, algorithm=algorithm,
            alpha=alpha, beta=beta, early_termination=early_termination,
            layer_order=layer_order, channel_format=channel_format,
            output_format=output_format, alpha_schedule=alpha_schedule,
        )

    if iterations < 0:
        raise ValueError("iterations must not be negative")
    row_seq = _resolve_layer_order(params, layer_order)
    Z, nc, nr = params.Z_c, params.num_cols, params.num_rows
    E = len(params.edges[0])
    lib = _library()
    max_deg = _graph_plan(params, row_seq)[2]
    if max_deg > lib.ldpc_layered_max_degree() or Z > lib.ldpc_layered_max_z():
        raise ValueError(
            f"kernel limits exceeded: row degree {max_deg}, Z={Z}"
        )
    edges, row_start = _graph_device(params, row_seq, llr.device)

    batch_shape = llr.shape[:-1]
    flat = llr.to(torch.float32).reshape(-1, nci * Z).contiguous()
    n = flat.shape[0]
    dev = flat.device
    bits = torch.empty((n, out_cols * Z), dtype=torch.int8, device=dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    iters = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        # scratch for the check-to-variable messages; never zero-filled
        # (sweep 0 does not read it)
        c2v = torch.empty((n, E, Z), dtype=torch.float32, device=dev)
        lo, hi = params.filler_range_d if channel_format == "d" else (0, 0)
        a0, n0 = alpha_schedule if alpha_schedule is not None else (alpha, 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.ldpc_layered_decode(
                flat.data_ptr(), bits.data_ptr(), ok.data_ptr(),
                iters.data_ptr(), c2v.data_ptr(), edges.data_ptr(),
                row_start.data_ptr(), n, Z, nc, nr, E, out_cols,
                int(channel_format == "d"), lo, hi, int(iterations),
                int(bool(early_termination)),
                int(algorithm == "offset-min-sum"),
                float(alpha), float(beta), float(a0), int(n0), stream,
            )
        if err != 0:
            raise RuntimeError(f"ldpc_layered kernel launch failed: CUDA error {err}")
        LAUNCHES += 1
    return DecodeResult(
        bits=bits.reshape(batch_shape + (out_cols * Z,)),
        parity_ok=ok.to(torch.bool).reshape(batch_shape),
        iterations=iters.reshape(batch_shape),
    )
