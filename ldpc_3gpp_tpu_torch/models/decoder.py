"""Transport-block decoder: the inverse TS38.212 chain with HARQ state.

Batched, functional replacement for NRLDPCDecoder (NRLDPCDecoder.m:133-356).
HARQ state is an explicit tuple of tensors carried by the caller (the
reference's DiscreteState buffers, NRLDPCDecoder.m:64-95); ``reset`` is simply
creating a fresh state.  The chain:

    g~ --split/deinterleave--> e~ --accumulate (Chase combining) + HARQ
    accumulate--> d~ --prepend punctured 2Z zeros, pin fillers--> BP decode
    --> c^ --CB CRC gate + b^ buffer--> b^ --TB CRC--> a^, tb_ok

Where the reference returns ``[]`` on failure (NRLDPCDecoder.m:337-339), this
returns the decoded bits plus a per-codeword ``tb_ok`` flag — the natural
batched equivalent.

Everything runs on the device of the input LLRs.  Both schedules (flooding,
layered), the three check rules (sum-product, min-sum, offset-min-sum) and
``message_dtype`` 'float32' / 'bfloat16' are ported; the defaults of
``algorithm`` and ``schedule`` are the JAX package's (sum-product, flooding),
the literal comm.LDPCDecoder semantics of the reference.  Still to port
(ROADMAP.md): backend 'reference'.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import decoder_cuda
from ..ops.crc import crc_check
from ..ops.decoder_fast import decode as bp_decode_fast
from ..ops.decoder_layered import decode as bp_decode_layered
from ..ops.modulation import Q_M, demodulate_planes
from ..ops.rate_match import accumulate_llrs, deinterleave
from ..spec.params import LDPCParams
from ..utils.device import resolve_device

# BP decoder implementations:
#   'auto' — ops/decoder_cuda.decode: the CUDA kernel of the schedule for
#            CUDA tensors, the kernel's plain version for CPU tensors
#   'cuda' — the same, or an error if the tensors are not on a GPU
#   'fast' — the plain PyTorch decoders on whatever device the tensors are:
#            flooding (ops/decoder_fast.py) or layered
#            (ops/decoder_layered.py); float32 messages only
DECODE_BACKENDS = ("auto", "cuda", "fast")

# Large finite stand-in for the reference's +inf filler LLRs
# (NRLDPCDecoder.m:264).  Finite so that inf - inf NaNs can never appear in
# message passing; far above any channel LLR magnitude.  Aliases the
# kernel's constant: the kernel pins fillers itself in its fused
# channel_format='d' input path, and both paths must agree bit for bit.
FILLER_LLR = decoder_cuda.FILLER_LLR


class HARQState(NamedTuple):
    """Per-transport-block soft/hard buffers (NRLDPCDecoder.m:64-95)."""

    d_buf: torch.Tensor  # (..., C, N_cb) float32 accumulated channel LLRs
    b_buf: torch.Tensor  # (..., B) int8 best-so-far decoded bits
    cb_ok: torch.Tensor  # (..., C) bool latched per-code-block CRC pass flags


class TBDecodeResult(NamedTuple):
    a_hat: torch.Tensor  # (..., A) int8 decoded info bits
    tb_ok: torch.Tensor  # (...,) bool transport block decoded successfully
    state: HARQState  # updated HARQ buffers
    cb_crc_ok: torch.Tensor  # (..., C) this transmission's CB CRC results
    parity_ok: torch.Tensor  # (..., C) LDPC parity satisfied per code block
    iterations: torch.Tensor  # (..., C) int32 BP iterations per code block


def init_harq_state(params: LDPCParams, batch_shape=(), device="cuda") -> HARQState:
    """Fresh buffers — the reference's reset() (NRLDPCDecoder.m:343-356)."""
    batch_shape = tuple(batch_shape)
    device = resolve_device(device)
    return HARQState(
        d_buf=torch.zeros(
            batch_shape + (params.C, params.N_cb), dtype=torch.float32, device=device
        ),
        b_buf=torch.zeros(batch_shape + (params.B,), dtype=torch.int8, device=device),
        cb_ok=torch.zeros(batch_shape + (params.C,), dtype=torch.bool, device=device),
    )


def split_rate_matched(params: LDPCParams, g_tilde: torch.Tensor) -> torch.Tensor:
    """Sections 5.5 + 5.4.2.2 + 5.4.2.1 inverse: (..., G) -> (..., C, N).

    Splits per code block, deinterleaves, and accumulates into the N-length
    circular buffer (repeated positions Chase-combine,
    NRLDPCDecoder.m:143-234).  Excluded code blocks (E_r == 0) produce an
    all-zero LLR row.
    """
    assert g_tilde.shape[-1] == params.G, (
        f"expected {params.G} rate-matched LLRs, got {g_tilde.shape[-1]}"
    )
    rows = []
    off = 0
    for r in range(params.C):
        E = params.E_r[r]
        if E == 0:
            rows.append(torch.zeros(
                g_tilde.shape[:-1] + (params.N,),
                dtype=torch.float32, device=g_tilde.device,
            ))
            continue
        f = g_tilde[..., off : off + E].to(torch.float32)
        off += E
        e = deinterleave(f, params.Q_m)
        rows.append(accumulate_llrs(params, e, E))
    return torch.stack(rows, dim=-2)


def split_rate_matched_symbols(
    params: LDPCParams,
    y: torch.Tensor,
    modulation: str,
    noise_var,
    method: str = "exact",
) -> torch.Tensor:
    """``split_rate_matched(demodulate(y))`` with the Section 5.4.2.2
    deinterleaver's element-shuffle fused away: (..., G/Q_m) received
    symbols -> (..., C, N) circular-buffer LLRs.

    ops/modulation.demodulate_planes emits each code block's LLRs directly
    as deinterleaved planes (plane i = stream i), so the per-element
    (S, Q_m) transpose of the full stream never materializes.  Bit-exact
    vs the composition.
    """
    qm = Q_M[modulation]
    assert y.shape[-1] * qm == params.G, (
        f"expected {params.G // qm} symbols, got {y.shape[-1]}"
    )
    rows = []
    soff = 0
    for r in range(params.C):
        E = params.E_r[r]
        if E == 0:
            rows.append(torch.zeros(
                y.shape[:-1] + (params.N,), dtype=torch.float32, device=y.device
            ))
            continue
        S = E // qm
        planes = demodulate_planes(
            y[..., soff : soff + S], modulation, noise_var, method
        )  # (..., qm, S)
        soff += S
        e = planes.reshape(planes.shape[:-2] + (E,)).to(torch.float32)
        rows.append(accumulate_llrs(params, e, E))
    return torch.stack(rows, dim=-2)


def _kernel_engaged(backend: str, algorithm: str, params: LDPCParams) -> bool:
    """Will this (backend, algorithm, params) go through ``decoder_cuda``?

    The chain uses it to pick the kernel's fused ``channel_format='d'``
    input and ``output_format='sys'`` output exactly when the kernel (or,
    for CPU tensors, its plain version) will consume them.
    """
    if backend == "cuda":
        return True
    return (
        backend == "auto"
        and algorithm in decoder_cuda.ALGORITHMS
        and decoder_cuda.supports(params)
    )


def _bp_decode_fast(params, llr, *, schedule, **kw):
    """Backend 'fast': dispatch on ``schedule`` to the plain decoders."""
    if schedule == "flooding":
        return bp_decode_fast(params, llr, **kw)
    if schedule == "layered":
        return bp_decode_layered(params, llr, **kw)
    raise ValueError(f"backend does not implement schedule {schedule!r}")


def decode_transport_block(
    params: LDPCParams,
    g_tilde: torch.Tensor,
    state: Optional[HARQState] = None,
    iterations: int = 50,
    algorithm: str = "sum-product",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    backend: str = "fast",
    schedule: str = "flooding",
    message_dtype: str = "float32",
    alpha_schedule=None,
) -> TBDecodeResult:
    """Full decode chain for one (re)transmission of (..., G) channel LLRs.

    ``state=None`` decodes standalone (I_HARQ = 0); passing the previous
    TBDecodeResult.state accumulates LLRs and latched code blocks across
    retransmissions (I_HARQ = 1, NRLDPCDecoder.m:236-239, 286-314).
    """
    d_tilde = split_rate_matched(params, g_tilde)  # (..., C, N)
    return decode_transport_block_d(
        params, d_tilde, state,
        iterations=iterations, algorithm=algorithm, alpha=alpha, beta=beta,
        early_termination=early_termination, backend=backend,
        schedule=schedule, message_dtype=message_dtype,
        alpha_schedule=alpha_schedule,
    )


@torch.no_grad()
def decode_transport_block_d(
    params: LDPCParams,
    d_tilde: torch.Tensor,
    state: Optional[HARQState] = None,
    iterations: int = 50,
    algorithm: str = "sum-product",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    backend: str = "fast",
    schedule: str = "flooding",
    message_dtype: str = "float32",
    alpha_schedule=None,
) -> TBDecodeResult:
    """``decode_transport_block`` from the (..., C, N) circular-buffer LLRs.

    Entry point for callers that produced d~ without materializing the
    rate-matched stream (the simulation chain's fused symbol path,
    ``split_rate_matched_symbols``).  Semantics identical from d~ onward.

    The device is that of ``d_tilde``: with backends 'auto' and 'cuda', CUDA
    tensors go through the kernel of ``schedule`` and CPU tensors through its
    plain version; backend 'cuda' raises for CPU tensors.
    """
    if backend not in DECODE_BACKENDS:
        if backend == "reference":
            raise NotImplementedError(
                "backend 'reference' is not ported yet (ROADMAP.md queue A: "
                "ops/decoder.py)"
            )
        raise ValueError(f"unknown backend {backend!r}")
    dev = d_tilde.device
    if backend == "cuda" and dev.type != "cuda":
        raise RuntimeError("backend 'cuda' needs CUDA tensors")

    C, Z, K, Kp, N_cb = params.C, params.Z_c, params.K, params.K_prime, params.N_cb
    L = params.cb_crc_len
    payload = Kp - L
    batch_shape = tuple(d_tilde.shape[:-2])
    harq = state is not None
    if state is None:
        state = init_harq_state(params, batch_shape, device=dev)

    d_tilde = d_tilde.to(torch.float32)
    if harq:
        # out of place: the caller's d_tilde stays as it was
        d_tilde = torch.cat(
            [d_tilde[..., :N_cb] + state.d_buf, d_tilde[..., N_cb:]], dim=-1
        )
    d_buf = d_tilde[..., :N_cb]

    kw = dict(
        iterations=iterations, algorithm=algorithm, alpha=alpha, beta=beta,
        early_termination=early_termination, schedule=schedule,
    )
    engaged = _kernel_engaged(backend, algorithm, params)
    if alpha_schedule is not None:
        # iteration-dependent NMS normalization: the kernels have it in both
        # schedules, the plain decoders of backend 'fast' only in the
        # layered one (flooding there is the literal reference semantics)
        if not engaged and schedule != "layered":
            raise ValueError(
                "alpha_schedule requires the kernel backends or the plain "
                "layered decoder (schedule='layered')"
            )
        kw["alpha_schedule"] = (float(alpha_schedule[0]), int(alpha_schedule[1]))
    if message_dtype != "float32":
        if backend not in ("cuda", "auto"):
            raise ValueError(
                f"message_dtype={message_dtype} is a knob of the kernels; "
                f"backend {backend!r} is f32-only"
            )
        kw["message_dtype"] = message_dtype

    # Rebuild the full codeword LLRs: 2Z punctured zeros + d, fillers pinned
    # to +FILLER_LLR (known zero bits; NRLDPCDecoder.m:262-264).  When the
    # kernel is engaged it performs both steps itself while it loads
    # (channel_format='d') and emits only the K bits read below
    # (output_format='sys'), in either schedule.  (Kp >= 2Z guards the corner
    # where fillers would reach into the punctured region — never seen for
    # valid NR parameters, but the fused path synthesizes zeros there while
    # the cw path pins FILLER.)
    if engaged and Kp >= 2 * Z:
        res = decoder_cuda.decode(
            params, d_tilde, channel_format="d", output_format="sys", **kw
        )
    else:
        zeros2z = torch.zeros(batch_shape + (C, 2 * Z), dtype=torch.float32, device=dev)
        dec_llr = torch.cat([zeros2z, d_tilde], dim=-1)
        if Kp < K:
            dec_llr[..., Kp:K] = FILLER_LLR
        if backend == "fast":
            res = _bp_decode_fast(params, dec_llr, **kw)
        else:
            res = decoder_cuda.decode(params, dec_llr, **kw)
    c_hat = res.bits  # (..., C, num_cols*Z), or (..., C, K) from the fused path

    # Section 5.2.2 inverse: CB CRC gate (only exists when C > 1,
    # NRLDPCDecoder.m:298-301) and scheduled-code-block masking.
    if C > 1:
        cb_crc_ok = ~crc_check(c_hat[..., :Kp], params.cb_crc)
    else:
        cb_crc_ok = torch.ones(batch_shape + (C,), dtype=torch.bool, device=dev)
    scheduled = torch.tensor(params.CBGTI_flags, dtype=torch.bool, device=dev)
    accept = cb_crc_ok & scheduled  # (..., C)

    new_bits = c_hat[..., :payload].to(torch.int8)  # (..., C, K'-L)
    old_bits = state.b_buf.reshape(batch_shape + (C, payload))
    b_blocks = torch.where(accept.unsqueeze(-1), new_bits, old_bits)
    b_hat = b_blocks.reshape(batch_shape + (params.B,))
    cb_ok = state.cb_ok | accept

    # Section 5.1 inverse: TB CRC + all-code-blocks-latched gate
    # (NRLDPCDecoder.m:336-339).
    tb_ok = ~crc_check(b_hat, params.tb_crc) & cb_ok.all(dim=-1)
    a_hat = b_hat[..., : params.A]

    new_state = HARQState(d_buf=d_buf, b_buf=b_hat, cb_ok=cb_ok)
    return TBDecodeResult(
        a_hat=a_hat,
        tb_ok=tb_ok,
        state=new_state,
        cb_crc_ok=cb_crc_ok,
        parity_ok=res.parity_ok,
        iterations=res.iterations,
    )
