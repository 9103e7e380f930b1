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
binary per schedule that serves every base graph and lifting size.  Still to
port (ROADMAP.md queue B): several small-Z codewords per block.
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

# Number of launches of each kernel made by ``decode`` in this process.
LAUNCHES = {name: 0 for name in KERNEL_NAMES.values()}

# Argument types of ``ldpc_layered_decode`` and ``ldpc_flooding_decode``:
# seven pointers (llr, bits, ok, iters, c2v, edges, row_start), thirteen ints
# (ncw, Z, nc, nr, E, out_cols, d_input, fill_lo, fill_hi, iterations,
# early_termination, rule, bf16_messages), alpha, beta, alpha0, n0 and the
# stream.
DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
    + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
)

# Argument types of the test entry ``ldpc_phi``: x, y, n, stream.
PHI_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

# The kernels' rule codes (RULE_* in csrc/ldpc_bp.cuh).
_RULE_CODES = {"min-sum": 0, "offset-min-sum": 1, "sum-product": 2}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports(params: LDPCParams) -> bool:
    """Whether the kernels take this code: every TS38.212 lifting size fits
    one block (Z <= 384).  Routing very small Z elsewhere is undecided."""
    return params.Z_c <= 384


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
def _graph_device(params: LDPCParams, row_seq, device: torch.device):
    """Device copies of the graph arrays, cached per (params, order, device)."""
    edges, row_start, _ = _graph_plan(params, row_seq)
    return (
        torch.from_numpy(edges).to(device).contiguous(),
        torch.from_numpy(row_start).to(device).contiguous(),
    )


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The built library of kernel ``name`` with its functions declared."""
    lib = kernels_build.load(name)
    decode_fn = getattr(lib, name + "_decode")
    decode_fn.argtypes = DECODE_ARGTYPES
    decode_fn.restype = ctypes.c_int
    for fn, argtypes in (("max_degree", []), ("max_z", []),
                         ("max_shared_bytes", []),
                         ("shared_bytes", [ctypes.c_int] * 4)):
        f = getattr(lib, f"{name}_{fn}")
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    if name == KERNEL_NAMES["flooding"]:
        lib.ldpc_phi.argtypes = PHI_ARGTYPES
        lib.ldpc_phi.restype = ctypes.c_int
    return lib


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
) -> DecodeResult:
    """Plain PyTorch version of ``decode`` on the device of ``llr``.

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

    message_dtype='bfloat16' (min-sum family only) stores the per-edge check
    messages in bfloat16, halving the scratch and its traffic; arithmetic
    stays float32 and messages are only rounded on store.  Sum-product is
    float32-only, so that it stays bit-exact.

    layer_order: 'reversed' (default), 'natural' or a permutation tuple;
    ignored by the flooding schedule, whose trajectory is order-invariant.
    alpha_schedule=(alpha0, n0) (min-sum only): alpha0 for the first n0
    update sweeps, ``alpha`` after.

    A CUDA tensor launches the kernel on the current stream without
    synchronising (or raises); a CPU tensor runs ``decode_plain``.  The
    kernels keep the per-edge messages in a scratch tensor of E*Z elements
    per codeword (474 KiB in float32 at BG1 Z=384), allocated here.
    """
    dtype, nci, out_cols, alpha_schedule = _check_arguments(
        params, llr, algorithm, schedule, message_dtype, channel_format,
        output_format, alpha_schedule)
    if not llr.is_cuda:
        return decode_plain(
            params, llr, iterations=iterations, algorithm=algorithm,
            alpha=alpha, beta=beta, early_termination=early_termination,
            schedule=schedule, message_dtype=message_dtype,
            layer_order=layer_order, channel_format=channel_format,
            output_format=output_format, alpha_schedule=alpha_schedule,
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
    lib = _library(name)
    max_deg = _graph_plan(params, row_seq)[2]
    if (max_deg > getattr(lib, name + "_max_degree")()
            or Z > getattr(lib, name + "_max_z")()):
        raise ValueError(
            f"kernel limits exceeded: row degree {max_deg}, Z={Z}"
        )
    dev = llr.device
    need = getattr(lib, name + "_shared_bytes")(Z, nc, nr, E)
    with torch.cuda.device(dev):
        have = getattr(lib, name + "_max_shared_bytes")()
    if need > have:
        raise ValueError(
            f"{name} needs {need} bytes of shared memory per block for "
            f"num_cols={nc}, Z={Z}; the device allows {have}"
        )
    edges, row_start = _graph_device(params, row_seq, dev)

    batch_shape = llr.shape[:-1]
    flat = llr.to(torch.float32).reshape(-1, nci * Z).contiguous()
    n = flat.shape[0]
    bits = torch.empty((n, out_cols * Z), dtype=torch.int8, device=dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    iters = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        # scratch for the check-to-variable messages; never zero-filled
        # (sweep 0 does not read it)
        c2v = torch.empty((n, E, Z), dtype=dtype, device=dev)
        lo, hi = params.filler_range_d if channel_format == "d" else (0, 0)
        a0, n0 = alpha_schedule if alpha_schedule is not None else (alpha, 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, name + "_decode")(
                flat.data_ptr(), bits.data_ptr(), ok.data_ptr(),
                iters.data_ptr(), c2v.data_ptr(), edges.data_ptr(),
                row_start.data_ptr(), n, Z, nc, nr, E, out_cols,
                int(channel_format == "d"), lo, hi, int(iterations),
                int(bool(early_termination)), _RULE_CODES[algorithm],
                int(dtype == torch.bfloat16),
                float(alpha), float(beta), float(a0), int(n0), stream,
            )
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return DecodeResult(
        bits=bits.reshape(batch_shape + (out_cols * Z,)),
        parity_ok=ok.to(torch.bool).reshape(batch_shape),
        iterations=iters.reshape(batch_shape),
    )
