"""Transport-block encoder: the full TS38.212 Sections 5.1-5.5 encode chain.

Batched, functional replacement for the reference's NRLDPCEncoder System
object (NRLDPCEncoder.m:60-256).  All segmentation/rate-matching geometry is
static per LDPCParams:

    a --CRC--> b --segment(+CB CRC)--> c --QC-LDPC--> d --select/interleave/
    concat--> g

Filler bits: the reference threads NaNs through the pipeline to mark fillers
(NRLDPCEncoder.m:120-122,150-155); here filler positions are static indices,
so fillers are simply encoded as 0 and skipped by the rate-matching slices
(ops/rate_match.py).  The emitted bits are identical.

Tensors stay on the device of the info bits ``a``.
"""
from __future__ import annotations

import torch

from ..ops.crc import crc_attach
from ..ops.encoder import encode as ldpc_encode_rolls
from ..ops.encoder import encode_mxu as ldpc_encode_mxu
from ..ops.modulation import Q_M, modulate_planes
from ..ops.rate_match import interleave, select_bits
from ..spec.params import LDPCParams

# LDPC core implementations (bit-identical; see ops/encoder.py):
#   'rolls' — structured XOR-of-rolled-blocks, no extra memory (default)
#   'mxu'   — dense GF(2) generator matmul (int8 in, int32 sums); keeps a
#             K x P int8 generator per config on the device
ENCODE_BACKENDS = {"mxu": ldpc_encode_mxu, "rolls": ldpc_encode_rolls}


def segment(params: LDPCParams, b: torch.Tensor) -> torch.Tensor:
    """Section 5.2.2 code block segmentation: (..., B) -> (..., C, K).

    Splits the CRC-attached transport block into C payloads of K'-L bits,
    appends the per-block CRC24B when C > 1, and zero-fills the filler
    positions K'..K-1 (NRLDPCEncoder.m:92-124).
    """
    C, Kp, K = params.C, params.K_prime, params.K
    L = params.cb_crc_len
    payload = Kp - L
    assert b.shape[-1] == params.B == C * payload
    blocks = b.reshape(b.shape[:-1] + (C, payload))
    if C > 1:
        blocks = crc_attach(blocks, params.cb_crc)
    filler = torch.zeros(
        blocks.shape[:-1] + (K - Kp,), dtype=blocks.dtype, device=blocks.device
    )
    return torch.cat([blocks, filler], dim=-1)


def rate_match(params: LDPCParams, d: torch.Tensor) -> torch.Tensor:
    """Sections 5.4.2.1-5.5: (..., C, N) -> (..., G).

    Per code block: circular-buffer bit selection from k_0 (filler-skipping),
    Q_m bit interleaving, then concatenation.  Code blocks excluded by CBGTI
    have E_r == 0 and emit nothing (NRLDPC.m:485-507).
    """
    pieces = []
    for r in range(params.C):
        E = params.E_r[r]
        if E == 0:
            continue
        e = select_bits(params, d[..., r, :], E)
        pieces.append(interleave(e, params.Q_m))
    g = torch.cat(pieces, dim=-1)
    assert g.shape[-1] == params.G
    return g


def rate_match_symbols(
    params: LDPCParams, d: torch.Tensor, modulation: str
) -> torch.Tensor:
    """``modulate(rate_match(d))`` with the Section 5.4.2.2 interleaver's
    element-shuffle fused away: (..., C, N) -> (..., G/Q_m) symbols.

    Per code block, the selected bits reshape CONTIGUOUSLY into Q_m
    deinterleaved planes (plane i = e[i*S : (i+1)*S]) which
    ops/modulation.modulate_planes maps straight to symbols — bit-exact vs
    the composition while skipping two per-element transposes of the full
    rate-matched stream.
    """
    qm = Q_M[modulation]
    pieces = []
    for r in range(params.C):
        E = params.E_r[r]
        if E == 0:
            continue
        e = select_bits(params, d[..., r, :], E)
        planes = e.reshape(e.shape[:-1] + (qm, E // qm))
        pieces.append(modulate_planes(planes, modulation))
    tx = torch.cat(pieces, dim=-1)
    assert tx.shape[-1] == params.G // qm
    return tx


def _encode_to_d(params: LDPCParams, a: torch.Tensor, backend: str) -> torch.Tensor:
    """Sections 5.1-5.3: info bits -> the (..., C, N) rate-matching buffer."""
    assert a.shape[-1] == params.A, (
        f"expected {params.A} info bits per block, got {a.shape[-1]}"
    )
    b = crc_attach(a, params.tb_crc)
    c = segment(params, b)
    cw = ENCODE_BACKENDS[backend](params, c)
    # Puncture the first 2*Z_c systematic bits (NRLDPCEncoder.m:149-156).
    return cw[..., 2 * params.Z_c :]


def encode_transport_block(
    params: LDPCParams, a: torch.Tensor, backend: str = "rolls"
) -> torch.Tensor:
    """Full encode chain: (..., A) info bits -> (..., G) rate-matched bits.

    Equivalent to ``g = step(NRLDPCEncoder(...), a)`` (NRLDPCEncoder.m:60-67).
    """
    return rate_match(params, _encode_to_d(params, a, backend))


def encode_to_symbols(
    params: LDPCParams, a: torch.Tensor, modulation: str, backend: str = "rolls"
) -> torch.Tensor:
    """``modulate(encode_transport_block(a))`` via the fused symbol path.

    The simulation chain's encode: (..., A) info bits -> (..., G/Q_m)
    complex symbols, identical values to the composition but without
    materializing the interleaved bit stream g.
    """
    return rate_match_symbols(params, _encode_to_d(params, a, backend), modulation)
