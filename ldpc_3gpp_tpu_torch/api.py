"""System-object-style convenience API for users migrating from the reference.

Mirrors the MATLAB objects one-to-one — same construction keywords, the same
``step`` / ``reset`` lifecycle, tunable ``rv_id``/``G``/``Q_m``/``N_L``/
``CBGTI`` between steps (HARQ retransmissions), and the decoder's
empty-on-failure convention (``None`` instead of MATLAB's ``[]``):

    enc = NRLDPCEncoder(BG=2, A=3842, G=11526, Q_m=2)
    dec = NRLDPCDecoder(BG=2, A=3842, G=11526, Q_m=2, I_HARQ=1, iterations=8)
    mod = NRModulator("QPSK"); dem = NRDemodulator("QPSK", variance=0.5)

    g  = enc.step(a)            # (A,) bits -> (G,) bits
    tx = mod.step(g)
    llr = dem.step(rx)
    a_hat = dec.step(llr)       # (A,) bits or None
    dec.reset()                 # clear HARQ buffers for the next block

Numpy goes in and comes out; inside, every step is the functional chain on
the object's ``device`` (``"cuda"`` by default, where the decoder's
``backend="auto"`` runs the CUDA kernels; ``device="cpu"`` runs the plain
PyTorch versions).  A class asked for CUDA raises where there is none.  For
throughput, use the batched functional API directly (models.chain /
parallel.montecarlo) — per-call single-codeword stepping cannot amortise
launch costs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models.decoder import HARQState, decode_transport_block, init_harq_state
from .models.encoder import encode_transport_block
from .ops.channel import awgn, esn0_to_variance
from .ops.modulation import Q_M, demodulate, modulate
from .spec.params import LDPCParams
from .utils.device import resolve_device
from .utils.rng import make_generator


class _NRLDPCBase:
    """Shared parameter plumbing (the reference's NRLDPC base class)."""

    def __init__(self, BG=1, A=44, G=132, Q_m=1, N_L=1, rv_id=0, I_LBRM=0,
                 TBS_LBRM=None, CBGTI=(), device="cuda"):
        self.device = resolve_device(device)
        self._kw = dict(BG=BG, A=A, G=G, Q_m=Q_m, N_L=N_L, rv_id=rv_id,
                        I_LBRM=I_LBRM, TBS_LBRM=TBS_LBRM, CBGTI=tuple(CBGTI))
        self._params = LDPCParams(**self._kw)

    @property
    def params(self) -> LDPCParams:
        return self._params

    def _set(self, name, value):
        self._kw[name] = value
        self._params = LDPCParams(**self._kw)

    # Tunable properties (NRLDPC.m:51-85) — may change between steps.
    rv_id = property(lambda s: s._params.rv_id,
                     lambda s, v: s._set("rv_id", v))
    G = property(lambda s: s._params.G, lambda s, v: s._set("G", v))
    Q_m = property(lambda s: s._params.Q_m, lambda s, v: s._set("Q_m", v))
    N_L = property(lambda s: s._params.N_L, lambda s, v: s._set("N_L", v))
    CBGTI = property(lambda s: s._params.CBGTI,
                     lambda s, v: s._set("CBGTI", tuple(v)))

    def __getattr__(self, name):
        # expose every derived parameter (A, B, C, K, N, Z_c, E_r, k_0, ...)
        return getattr(object.__getattribute__(self, "_params"), name)


class NRLDPCEncoder(_NRLDPCBase):
    """step(a): (A,) or (batch, A) bits -> (G,) / (batch, G) uint8 bits."""

    def step(self, a) -> np.ndarray:
        a = np.asarray(a)
        single = a.ndim == 1
        batch = a[None] if single else a
        bits = torch.from_numpy(batch.astype(np.int8)).to(self.device)
        g = encode_transport_block(self._params, bits).cpu().numpy()
        return g[0] if single else g


class NRLDPCDecoder(_NRLDPCBase):
    """step(llr): (G,) / (batch, G) LLRs -> (A,) bits / (batch, A) or None.

    LLR convention: positive = bit 0 (MATLAB comm).  With I_HARQ != 0,
    successive steps accumulate LLRs for the same transport block until
    ``reset()`` (NRLDPCDecoder.m:21-35, :343-356).  For a single codeword,
    returns None when the transport block failed to decode (the reference
    returns []); for a batch, returns (a_hat, tb_ok).
    """

    def __init__(self, *args, I_HARQ=0, iterations=50,
                 algorithm="sum-product", backend="auto",
                 schedule="flooding", **kw):
        super().__init__(*args, **kw)
        self.I_HARQ = I_HARQ
        self.iterations = iterations
        self.algorithm = algorithm
        self.backend = backend
        self.schedule = schedule
        self._state: Optional[HARQState] = None

    def reset(self) -> None:
        self._state = None

    def step(self, llr):
        llr = np.asarray(llr, dtype=np.float32)
        single = llr.ndim == 1
        batch = llr[None] if single else llr
        state = self._state
        if self.I_HARQ and state is None:
            state = init_harq_state(self._params, (batch.shape[0],), self.device)
        res = decode_transport_block(
            self._params, torch.from_numpy(batch).to(self.device),
            state if self.I_HARQ else None, iterations=self.iterations,
            algorithm=self.algorithm, backend=self.backend,
            schedule=self.schedule,
        )
        if self.I_HARQ:
            self._state = res.state
        a_hat, tb_ok = res.a_hat.cpu().numpy(), res.tb_ok.cpu().numpy()
        if single:
            return a_hat[0] if bool(tb_ok[0]) else None
        return a_hat, tb_ok


class NRModulator:
    """step(bits) -> complex64 symbols (NRModulator.m)."""

    def __init__(self, modulation: str = "BPSK", device="cuda"):
        self.modulation = modulation
        self.Q_m = Q_M[modulation]
        self.device = resolve_device(device)

    def step(self, bits):
        bits = torch.from_numpy(np.asarray(bits, np.int8)).to(self.device)
        return modulate(bits, self.modulation).cpu().numpy()


class NRDemodulator:
    """step(rx) -> float32 LLRs; tunable noise ``variance`` (NRDemodulator.m:14)."""

    def __init__(self, modulation: str = "BPSK", variance: float = 1.0,
                 decision_method: str = "exact", device="cuda"):
        self.modulation = modulation
        self.Q_m = Q_M[modulation]
        self.variance = variance
        self.decision_method = decision_method
        self.device = resolve_device(device)

    def step(self, rx):
        rx = torch.from_numpy(np.asarray(rx, np.complex64)).to(self.device)
        return demodulate(rx, self.modulation, float(self.variance),
                          self.decision_method).cpu().numpy()


class AWGNChannel:
    """step(tx) -> rx at the configured Es/N0 (comm.AWGNChannel in SNR mode).

    The noise comes from a ``torch.Generator`` on ``device`` seeded with
    ``seed``: reproducible per (seed, device type), and a different stream
    from the JAX package's by design (utils/rng.py).
    """

    def __init__(self, snr_db: float = 0.0, seed: int = 0, device="cuda"):
        self.snr_db = snr_db
        self.device = resolve_device(device)
        self._generator = make_generator(seed, self.device)

    def step(self, tx):
        tx = torch.from_numpy(np.asarray(tx, np.complex64)).to(self.device)
        var = esn0_to_variance(self.snr_db, device=self.device)
        return awgn(self._generator, tx, var).cpu().numpy()
