"""TS38.212 code parameter resolution.

``LDPCParams`` replaces the reference's lazy ``matlab.System`` property
engine (NRLDPC.m:90-543): a frozen, hashable dataclass whose derived
parameters are all computed eagerly at construction.  Every quantity is
static Python data, so plans built from an ``LDPCParams`` instance are cached
per configuration and all TS38.212 control flow (segmentation, rate matching,
lifting) is resolved on the host before any tensor is touched.

The port's own copy of ``ldpc_3gpp_tpu/spec/params.py`` (pure Python).

Each derived field cites the reference implementation it matches.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

from .tables import (
    BG_DIMS,
    CRC_LENGTHS,
    UnsupportedParameters,
    base_graph,
    lifting_size,
    set_index,
)


@dataclasses.dataclass(frozen=True)
class LDPCParams:
    """All TS38.212 Sections 5.1-5.5 parameters for one (re)transmission.

    Inputs mirror the reference's settable properties (NRLDPC.m:20-85):

    - ``BG``: base graph, 1 or 2.
    - ``A``: transport block size (info bits).
    - ``G``: number of rate-matched bits for the transport block.
    - ``Q_m``: bits per modulation symbol (1, 2, 4, 6, 8).
    - ``N_L``: number of transmission layers (1..4).
    - ``rv_id``: redundancy version (0..3).
    - ``I_LBRM`` / ``TBS_LBRM``: limited-buffer rate matching switch / size.
    - ``CBGTI``: indices of code blocks excluded from this (re)transmission.
    """

    BG: int = 1
    A: int = 44
    G: int = 132
    Q_m: int = 1
    N_L: int = 1
    rv_id: int = 0
    I_LBRM: int = 0
    TBS_LBRM: Optional[int] = None  # None == MATLAB's inf (NRLDPC.m:45)
    CBGTI: Tuple[int, ...] = ()

    def __post_init__(self):
        # Set-time validation, mirroring NRLDPC.m:240-294.
        if self.BG not in (1, 2):
            raise UnsupportedParameters("Valid values of BG are 1 and 2.")
        if self.A < 0:
            raise UnsupportedParameters("A should not be negative.")
        if self.G < 0:
            raise UnsupportedParameters("G should not be negative.")
        if self.Q_m not in (1, 2, 4, 6, 8):
            raise UnsupportedParameters("Valid values of Q_m are 1, 2, 4, 6 and 8.")
        if not 1 <= self.N_L <= 4:
            raise UnsupportedParameters("N_L should be in the range 1 to 4.")
        if not 0 <= self.rv_id <= 3:
            raise UnsupportedParameters("Valid values of rv_id are 0, 1, 2 and 3.")
        if self.TBS_LBRM is not None and self.TBS_LBRM < 0:
            raise UnsupportedParameters("TBS_LBRM should not be negative.")
        object.__setattr__(self, "CBGTI", tuple(self.CBGTI))
        # Setup-time cross-field validation (NRLDPC.m:551-559).
        if self.B_prime % self.C != 0:
            raise UnsupportedParameters("B_prime must be a multiple of C.")
        if self.G % (self.Q_m * self.N_L) != 0:
            raise UnsupportedParameters("G must be a multiple of Q_m*N_L.")
        # Trigger the full derivation chain so invalid configs fail eagerly,
        # like the reference's first step() call.
        _ = self.E_r, self.k_0, self.i_LS

    # --- Section 5.1: CRC attachment --------------------------------------

    @functools.cached_property
    def tb_crc(self) -> str:
        """Transport-block CRC type (NRLDPC.m:297-303)."""
        return "CRC24A" if self.A > 3824 else "CRC16"

    @functools.cached_property
    def tb_crc_len(self) -> int:
        return CRC_LENGTHS[self.tb_crc]

    @functools.cached_property
    def B(self) -> int:
        """Info + TB-CRC bits (NRLDPC.m:316-318)."""
        return self.A + self.tb_crc_len

    # --- Section 5.2.2: code block segmentation ----------------------------

    @functools.cached_property
    def K_cb(self) -> int:
        """Maximum code block size (NRLDPC.m:321-331)."""
        return 8448 if self.BG == 1 else 3840

    @functools.cached_property
    def cb_crc(self) -> str:
        """Code-block CRC type (NRLDPC.m:347-353)."""
        return "None" if self.B <= self.K_cb else "CRC24B"

    @functools.cached_property
    def cb_crc_len(self) -> int:
        return CRC_LENGTHS[self.cb_crc]

    @functools.cached_property
    def C(self) -> int:
        """Number of code blocks (NRLDPC.m:334-344)."""
        if self.B <= self.K_cb:
            return 1
        return -(-self.B // (self.K_cb - self.cb_crc_len))

    @functools.cached_property
    def B_prime(self) -> int:
        """(NRLDPC.m:366-377)."""
        if self.B <= self.K_cb:
            return self.B
        return self.B + self.C * self.cb_crc_len

    @functools.cached_property
    def K_prime(self) -> int:
        """Info + CRC bits per code block (NRLDPC.m:380-382)."""
        return self.B_prime // self.C

    @functools.cached_property
    def K_b(self) -> int:
        """(NRLDPC.m:385-406)."""
        if self.BG == 1:
            return 22
        if self.K_prime > 640:
            return 10
        if self.K_prime > 560:
            return 9
        if self.K_prime > 192:
            return 8
        return 6

    @functools.cached_property
    def Z_c(self) -> int:
        """Lifting size (NRLDPC.m:409-411)."""
        return lifting_size(self.K_b, self.K_prime)

    @functools.cached_property
    def K(self) -> int:
        """Systematic bits per code block incl. filler (NRLDPC.m:414-425)."""
        return self.Z_c * (22 if self.BG == 1 else 10)

    # --- Section 5.3.2: LDPC encoding --------------------------------------

    @functools.cached_property
    def i_LS(self) -> int:
        """Lifting set index (NRLDPC.m:428-430)."""
        return set_index(self.Z_c)

    @functools.cached_property
    def N(self) -> int:
        """Encoded bits per code block after puncturing (NRLDPC.m:443-454)."""
        return self.Z_c * (66 if self.BG == 1 else 50)

    @functools.cached_property
    def num_rows(self) -> int:
        return BG_DIMS[self.BG][0]

    @functools.cached_property
    def num_cols(self) -> int:
        return BG_DIMS[self.BG][1]

    @functools.cached_property
    def num_sys_cols(self) -> int:
        return BG_DIMS[self.BG][2]

    @functools.cached_property
    def edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, shifts mod Z_c) edge list of the lifted PCM.

        This replaces the reference's materialised sparse PCM
        (NRLDPC.m:438-440 / get_pcm.m): a circulant P^s block at base
        position (r, c) connects check (r, z) to variable (c, (z+s) mod Z).
        """
        r, c, s = base_graph(self.BG, self.i_LS)
        return r, c, (s % self.Z_c).astype(np.int32)

    # --- Section 5.4.2.1: rate matching ------------------------------------

    @functools.cached_property
    def N_ref(self) -> int:
        """LBRM circular buffer limit (NRLDPC.m:457-460)."""
        if self.TBS_LBRM is None:
            return np.iinfo(np.int64).max
        # floor(TBS_LBRM / (C * 2/3)) computed in exact integer arithmetic
        return (3 * self.TBS_LBRM) // (2 * self.C)

    @functools.cached_property
    def N_cb(self) -> int:
        """Rate-matching circular buffer length (NRLDPC.m:463-469)."""
        if self.I_LBRM == 0:
            return self.N
        return min(self.N, self.N_ref)

    @functools.cached_property
    def CBGTI_flags(self) -> Tuple[int, ...]:
        """1 = code block scheduled in this transmission (NRLDPC.m:471-477)."""
        flags = [1] * self.C
        for idx in self.CBGTI:
            if idx < self.C:
                flags[idx] = 0
        return tuple(flags)

    @functools.cached_property
    def C_prime(self) -> int:
        """Number of scheduled code blocks (NRLDPC.m:480-482)."""
        return sum(self.CBGTI_flags)

    @functools.cached_property
    def E_r(self) -> Tuple[int, ...]:
        """Rate-matched length per code block (NRLDPC.m:485-507)."""
        if self.C_prime == 0:
            raise UnsupportedParameters("All code blocks excluded by CBGTI.")
        unit = self.N_L * self.Q_m
        q = self.G // unit
        E = []
        j = 0
        for r in range(self.C):
            if self.CBGTI_flags[r] == 0:
                E.append(0)
            else:
                if j <= self.C_prime - (q % self.C_prime) - 1:
                    E.append(unit * (q // self.C_prime))
                else:
                    E.append(unit * (-(-q // self.C_prime)))
                j += 1
        return tuple(E)

    @functools.cached_property
    def k_0(self) -> int:
        """Redundancy version start (TS38.212 Table 5.4.2.1-2, NRLDPC.m:510-543)."""
        Z, N_cb = self.Z_c, self.N_cb
        if self.BG == 1:
            num = {0: 0, 1: 17, 2: 33, 3: 56}[self.rv_id]
            den = 66
        else:
            num = {0: 0, 1: 13, 2: 25, 3: 43}[self.rv_id]
            den = 50
        return (num * N_cb) // (den * Z) * Z

    # --- Filler geometry (Section 5.2.2 / 5.3.2) ---------------------------

    @functools.cached_property
    def num_filler(self) -> int:
        """Filler bits per code block: positions K'..K-1 of c."""
        return self.K - self.K_prime

    @functools.cached_property
    def filler_range_d(self) -> Tuple[int, int]:
        """Filler positions inside d (the N-bit rate-matching buffer).

        d punctures the first 2*Z_c systematic bits, so fillers sit at
        [max(K'-2Z, 0), K-2Z) of d (NRLDPCDecoder.m:224).
        """
        lo = max(self.K_prime - 2 * self.Z_c, 0)
        hi = self.K - 2 * self.Z_c
        return lo, hi

    def with_rv(self, rv_id: int) -> "LDPCParams":
        """New params for a HARQ retransmission with a different rv_id."""
        return dataclasses.replace(self, rv_id=rv_id)

    def with_tx(self, rv_id=None, CBGTI=None) -> "LDPCParams":
        """New params for a HARQ (re)transmission.

        rv_id and CBGTI are the reference's tunable-between-steps properties
        (NRLDPC.m:51-85): a retransmission typically advances the redundancy
        version AND reschedules only the code blocks that failed (CBGTI
        excludes the rest, NRLDPC.m:471-482).  ``None`` keeps the current
        value.  C / K / N / N_cb are CBGTI-invariant, so HARQ buffers carry
        across the change; E_r redistributes G over the scheduled blocks.
        """
        changes = {}
        if rv_id is not None:
            changes["rv_id"] = rv_id
        if CBGTI is not None:
            changes["CBGTI"] = tuple(CBGTI)
        return dataclasses.replace(self, **changes)
