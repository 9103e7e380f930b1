"""End-to-end link chain: the Monte-Carlo simulation step.

One ``simulate_batch`` call reproduces the inner loop of the reference's
sweep scripts (plot_BLER_vs_SNR.m:116-162) for a whole batch of transport
blocks at once: random info bits -> encode -> modulate -> AWGN -> soft
demodulate -> decode, iterating the HARQ redundancy-version sequence with
LLR accumulation, and returning error counters.

``simulate_batch`` draws the info bits and the per-stage noise from an
explicit ``torch.Generator``; ``simulate_given`` does everything else from
given bits and noise, so the chain can be compared with the JAX package on
the same numpy-made inputs (the two packages' random streams differ).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.channel import complex_noise, esn0_to_variance
from ..ops.modulation import Q_M
from ..spec.params import LDPCParams
from ..utils.device import resolve_device
from .decoder import (
    decode_transport_block_d,
    init_harq_state,
    split_rate_matched_symbols,
)
from .encoder import encode_to_symbols


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration of one simulated link (one BLER curve point set).

    Mirrors the reference sweep script's arguments (plot_BLER_vs_SNR.m:30-42).
    """

    params: LDPCParams
    modulation: str = "QPSK"
    rv_sequence: Tuple[int, ...] = (0,)
    iterations: int = 50
    algorithm: str = "sum-product"
    alpha: float = 0.8125
    beta: float = 0.15
    demod_method: str = "exact"
    early_termination: bool = True
    # BP decoder implementation (models.decoder.DECODE_BACKENDS).  'auto'
    # runs the CUDA kernel of the schedule for CUDA tensors and its plain
    # version for CPU tensors — an implementation knob, not semantics: the
    # kernels are bit-exact vs the plain decoders.
    backend: str = "auto"
    schedule: str = "flooding"  # BP schedule: 'flooding' | 'layered'
    message_dtype: str = "float32"
    # codewords per block of the CUDA kernels (ops.decoder_cuda.decode): 0
    # automatic, 1 one block per codeword, P > 1 explicit.  Changes no result.
    codewords_per_block: int = 0
    # iteration-dependent NMS normalization (alpha0, n0): alpha0 for the
    # first n0 sweeps, then `alpha`.  None = constant alpha.
    alpha_schedule: Optional[Tuple[float, int]] = None
    # Per-stage CBGTI: cbgti_sequence[i] is the CBGTI tuple for rv stage i,
    # overriding params.CBGTI — the reference's tunable-between-steps CBGTI
    # (NRLDPC.m:71-85), where a retransmission reschedules only failed code
    # blocks.  None = params.CBGTI for every stage.  G redistributes over
    # the scheduled blocks per stage (E_r, NRLDPC.m:485-507); excluded
    # blocks decode from the HARQ buffer and keep their latched b_hat
    # (NRLDPCDecoder.m:286-318).
    cbgti_sequence: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        assert Q_M[self.modulation] == self.params.Q_m, (
            f"modulation {self.modulation} has Q_m={Q_M[self.modulation]} but "
            f"params.Q_m={self.params.Q_m}"
        )
        if self.cbgti_sequence is not None:
            seq = tuple(tuple(c) for c in self.cbgti_sequence)
            object.__setattr__(self, "cbgti_sequence", seq)
            assert len(seq) == len(self.rv_sequence), (
                f"cbgti_sequence has {len(seq)} stages but rv_sequence has "
                f"{len(self.rv_sequence)}"
            )
            for c in seq:  # every stage must keep >= 1 scheduled block
                self.params.with_tx(CBGTI=c).E_r

    def stage_params(self, stage: int) -> LDPCParams:
        """Code parameters of rv stage ``stage`` of the HARQ sequence."""
        return self.params.with_tx(
            rv_id=self.rv_sequence[stage],
            CBGTI=(None if self.cbgti_sequence is None
                   else self.cbgti_sequence[stage]),
        )


class BatchResult(NamedTuple):
    blocks: torch.Tensor  # () int32 number of transport blocks simulated
    block_errors: torch.Tensor  # () blocks where a_hat != a (or never decoded)
    # info bit errors; a block that never decoded counts all A bits as wrong
    # (matches the reference, whose failed decodes return [] — no bits at all)
    bit_errors: torch.Tensor  # ()
    # total BP iterations spent, reference protocol: a block that decoded at
    # an earlier rv stage stops retransmitting (plot_BLER_vs_SNR.m:124-137),
    # so its batched re-decodes at later stages are excluded
    iterations: torch.Tensor  # ()
    # (iterations+1,) histogram of per-code-block BP iteration counts over
    # every (block, CB, rv stage) decode of a not-yet-decoded block — the
    # early-termination mix, same stop-on-success protocol as `iterations`
    iteration_hist: torch.Tensor
    tb_ok: torch.Tensor  # (batch,) per-block success (for found-start logic)


def _efficient_batch(batch: int) -> int:
    """The batch a Monte-Carlo runner simulates for a requested ``batch``:
    the next multiple of 128 above 64, unchanged up to 64.

    The JAX package rounds so (its compiled program is better at multiples of
    128); the port keeps the rule so that a sweep with the same arguments
    simulates the same number of blocks per call in both packages.
    ``simulate_batch`` itself simulates exactly the batch it is given.
    """
    return batch if batch <= 64 else -(-batch // 128) * 128


@torch.no_grad()
def simulate_given(
    cfg: ChainConfig,
    a: torch.Tensor,
    noise_per_stage: Sequence[torch.Tensor],
    noise_var,
) -> BatchResult:
    """The chain from given info bits and noise, on the device of ``a``.

    a: (batch, A) int8 info bits.  noise_per_stage[i]: (batch, G/Q_m)
    complex64 additive noise of rv stage i (already scaled to ``noise_var``,
    the total complex variance the demodulator is told).

    Each block runs the HARQ loop of plot_BLER_vs_SNR.m:124-137: encode and
    transmit rv_sequence[0], then accumulate retransmissions until the TB
    decodes.  Already-decoded blocks are frozen while the batch continues.
    """
    p0 = cfg.params
    batch = a.shape[0]
    dev = a.device
    assert len(noise_per_stage) == len(cfg.rv_sequence)

    state = init_harq_state(p0, (batch,), device=dev)
    success = torch.zeros((batch,), dtype=torch.bool, device=dev)
    a_hat = torch.zeros_like(a)
    total_iters = torch.zeros((), dtype=torch.int32, device=dev)
    iter_hist = torch.zeros((cfg.iterations + 1,), dtype=torch.int64, device=dev)

    for stage, noise in enumerate(noise_per_stage):
        p = cfg.stage_params(stage)
        # Fused symbol path: the Section 5.4.2.2 (de)interleaver shuffles
        # compose away against the modulator's bit-plane structure, so the
        # interleaved bit/LLR streams g and g~ never materialize.
        tx = encode_to_symbols(p, a, cfg.modulation)
        rx = tx + noise
        d_tilde = split_rate_matched_symbols(
            p, rx, cfg.modulation, noise_var, cfg.demod_method
        )
        res = decode_transport_block_d(
            p,
            d_tilde,
            state,
            iterations=cfg.iterations,
            algorithm=cfg.algorithm,
            alpha=cfg.alpha,
            beta=cfg.beta,
            early_termination=cfg.early_termination,
            backend=cfg.backend,
            schedule=cfg.schedule,
            message_dtype=cfg.message_dtype,
            alpha_schedule=cfg.alpha_schedule,
            codewords_per_block=cfg.codewords_per_block,
        )
        state = res.state
        newly = res.tb_ok & ~success
        a_hat = torch.where(newly[:, None], res.a_hat, a_hat)
        # Iteration accounting follows the reference's stop-on-success HARQ
        # protocol (plot_BLER_vs_SNR.m:124-137: `while isempty(a_hat)`): the
        # batch necessarily re-decodes already-successful blocks at later rv
        # stages, but those decodes would never happen in the reference, so
        # they are excluded from both observables.
        active = ~success  # blocks still undecoded BEFORE this stage
        iters = res.iterations.to(torch.int64)  # (batch, C)
        counted = active[:, None].expand_as(iters).to(torch.int64)
        success = success | res.tb_ok
        total_iters = total_iters + (iters * counted).sum().to(torch.int32)
        # histogram by index_add_ (integer adds: exact in any order), which
        # unlike bincount or a boolean mask needs no host synchronisation
        iter_hist.index_add_(0, iters.reshape(-1), counted.reshape(-1))

    bits_equal = (a_hat == a).all(dim=-1)
    tb_ok = success & bits_equal  # undetected CRC errors still count as errors
    bit_errs = torch.where(
        success[:, None], a_hat != a, torch.ones_like(a, dtype=torch.bool)
    ).sum()

    return BatchResult(
        blocks=torch.tensor(batch, dtype=torch.int32, device=dev),
        block_errors=(~tb_ok).sum().to(torch.int32),
        bit_errors=bit_errs.to(torch.int32),
        iterations=total_iters,
        iteration_hist=iter_hist.to(torch.int32),
        tb_ok=tb_ok,
    )


def simulate_batch(
    cfg: ChainConfig,
    generator: torch.Generator,
    esn0_db,
    batch: int,
    device="cuda",
) -> BatchResult:
    """Simulate ``batch`` independent transport blocks at Es/N0 ``esn0_db``.

    Draws the info bits and each rv stage's noise from ``generator`` (which
    must live on ``device``) and runs ``simulate_given``.  Exactly ``batch``
    blocks are simulated.  Runs on a CUDA device unless ``device='cpu'`` is
    passed; raises if CUDA is asked for and absent.
    """
    dev = resolve_device(device)
    p0 = cfg.params
    noise_var = esn0_to_variance(esn0_db, device=dev)
    a = torch.randint(
        0, 2, (batch, p0.A), generator=generator, device=dev, dtype=torch.int8
    )
    symbols = p0.G // Q_M[cfg.modulation]
    noise = [
        complex_noise(generator, (batch, symbols), noise_var, dev)
        for _ in cfg.rv_sequence
    ]
    return simulate_given(cfg, a, noise, noise_var)
