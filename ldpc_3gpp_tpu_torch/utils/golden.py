"""ctypes bindings for the native conformance oracle (native/golden.cpp).

The oracle is an independently written scalar TS38.212 implementation (dense
GF(2) core solve, literal spec rate-matching loops, bit-serial CRC, scalar
lifted-adjacency BP) used by the differential testbench — the same role
nrULSCH plays for the reference (testbench.m:59-68), extended beyond it to
the decoder core and the full TB-level decode chain.  Pure numpy in and out.

The library is compiled from the checkout's ``native/`` sources with the
flags of ``native/Makefile`` into the port's build directory
(``build/ldpc_3gpp_tpu_torch/``, beside the CUDA kernels), named by a hash
of the sources and the flags, so nothing is written into ``native/``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..kernels_build import BUILD_DIR

# The oracle sources live in the repo's native/ checkout directory (they are
# deliberately NOT packaged: the oracle's value is being an independent
# artifact a reviewer can read next to the Makefile that builds it).
# LDPC_NATIVE_DIR overrides for installs that vendored the sources elsewhere.
_NATIVE_DIR = os.environ.get(
    "LDPC_NATIVE_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "native"),
)
_SOURCES = ("golden.cpp", "base_graphs.h")
# native/Makefile's flags.  -ffp-contract=off: the decoder oracle's
# bit-exactness contract forbids fused multiply-adds changing rounding.
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-ffp-contract=off")
_lib: Optional[ctypes.CDLL] = None

#: BG -> number of base-graph columns (lifted codeword width = n_cols * Z).
N_COLS = {1: 68, 2: 52}

_ALGO = {"min-sum": 0, "offset-min-sum": 1, "sum-product": 2}


def library_path() -> str:
    """Where the oracle library is (to be) built: named by a hash of the
    sources and the flags."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXXFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgolden-{h.hexdigest()[:16]}.so")


def _build() -> str:
    """Compile the oracle unless it is built already; returns its path."""
    if not os.path.isdir(_NATIVE_DIR):
        # The oracle is a source-checkout artifact: fail clearly instead of
        # an opaque compiler or dlopen error from an installed command.
        raise RuntimeError(
            "the native conformance oracle requires a source checkout "
            f"(native/golden.cpp + Makefile; looked in {_NATIVE_DIR!r}): "
            "run from the repo, install with `pip install -e .`, or point "
            "LDPC_NATIVE_DIR at a copy of the native/ directory"
        )
    path = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Serialize across processes (pytest-xdist workers build concurrently);
    # the library appears under its name only once it is whole.
    with open(os.path.join(BUILD_DIR, ".golden.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared",
                       "-o", tmp, os.path.join(_NATIVE_DIR, "golden.cpp")]
                out = subprocess.run(cmd, capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"building the oracle failed: {' '.join(cmd)}\n"
                        f"{out.stdout}{out.stderr}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def load() -> ctypes.CDLL:
    """Load (building if necessary) the golden oracle library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    lib.nr_golden_encode.restype = ctypes.c_int
    lib.nr_golden_encode.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.nr_golden_params.restype = ctypes.c_int
    lib.nr_golden_params.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.nr_golden_decode_core.restype = ctypes.c_int
    lib.nr_golden_decode_core.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.nr_golden_decode.restype = ctypes.c_int
    lib.nr_golden_decode.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.nr_golden_phi.restype = None
    lib.nr_golden_phi.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    lib.nr_golden_modulate.restype = ctypes.c_int
    lib.nr_golden_modulate.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.nr_golden_demodulate.restype = ctypes.c_int
    lib.nr_golden_demodulate.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return lib


def golden_phi(x: np.ndarray) -> np.ndarray:
    """Oracle phi(x) = -log(tanh(x/2)) with XLA:CPU's exact f32 rounding.

    Bit-exact vs ops/decoder._phi (the tanh/log recipes in
    native/golden.cpp) — the primitive behind the sum-product
    bit-exactness contract.
    """
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    lib.nr_golden_phi(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
    )
    return out


#: modulation name -> Q_m selector shared with ops.modulation.Q_M
_QM = {"BPSK": 1, "QPSK": 2, "16QAM": 4, "64QAM": 6, "256QAM": 8}

_DEMOD_METHOD = {"exact": 0, "maxlog": 1, "hard": 2}


def golden_modulate(bits: np.ndarray, modulation: str) -> np.ndarray:
    """Oracle TS38.211 modulation: (..., G) bits -> (..., G/Q_m) complex128.

    Scalar f64 evaluation of the Section 5.1 formulas in native/golden.cpp —
    the independent conformance counterpart of ops.modulation.modulate
    (the reference's separately-validated toolbox modulator,
    NRModulator.m:69-85).
    """
    lib = load()
    qm = _QM[modulation]
    bits = np.ascontiguousarray(np.asarray(bits, np.uint8))
    if bits.shape[-1] % qm:
        raise ValueError(f"bit count must be a multiple of Q_m={qm}")
    flat = bits.reshape(-1)
    s = flat.size // qm
    re = np.empty(s, np.float64)
    im = np.empty(s, np.float64)
    rc = lib.nr_golden_modulate(
        qm,
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size,
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError(f"nr_golden_modulate failed with code {rc}")
    return (re + 1j * im).reshape(bits.shape[:-1] + (bits.shape[-1] // qm,))


def golden_demodulate(
    y: np.ndarray, modulation: str, noise_var: float, method: str = "exact"
) -> np.ndarray:
    """Oracle soft demodulation: (..., S) symbols -> (..., S*Q_m) f64 LLRs.

    Full-constellation scalar f64 log-sum-exp / max-log per bit (positive =
    bit 0) — deliberately NOT the per-axis PAM factorization the port's
    demodulator uses (ops/modulation.py::_pam_axis_planes), so it
    independently checks both the factorization and the LLR scale (NRDemodulator.m:72-88 equivalence).
    'hard' returns +/-1e30 by the max-log sign.
    """
    lib = load()
    qm = _QM[modulation]
    y = np.ascontiguousarray(np.asarray(y, np.complex128))
    flat = y.reshape(-1)
    re = np.ascontiguousarray(flat.real)
    im = np.ascontiguousarray(flat.imag)
    llr = np.empty(flat.size * qm, np.float64)
    rc = lib.nr_golden_demodulate(
        qm, _DEMOD_METHOD[method], float(noise_var),
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        flat.size,
        llr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError(f"nr_golden_demodulate failed with code {rc}")
    return llr.reshape(y.shape[:-1] + (y.shape[-1] * qm,))


def golden_encode(
    BG: int,
    A: int,
    G: int,
    Q_m: int,
    a: np.ndarray,
    N_L: int = 1,
    rv_id: int = 0,
    I_LBRM: int = 0,
    TBS_LBRM: Optional[int] = None,
    CBGTI: Sequence[int] = (),
) -> np.ndarray:
    """Encode one transport block with the native oracle; returns G bits."""
    lib = load()
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint8))
    assert a.size == A
    g = np.zeros(G, dtype=np.uint8)
    cbgti = np.ascontiguousarray(np.asarray(list(CBGTI), dtype=np.int32))
    rc = lib.nr_golden_encode(
        BG, A, G, Q_m, N_L, rv_id,
        I_LBRM, -1 if TBS_LBRM is None else TBS_LBRM,
        cbgti.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(CBGTI),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"nr_golden_encode failed with code {rc}")
    return g


def golden_params(
    BG: int, A: int, G: int, Q_m: int, N_L: int = 1, rv_id: int = 0,
    I_LBRM: int = 0, TBS_LBRM: Optional[int] = None,
) -> dict:
    lib = load()
    out = np.zeros(8, dtype=np.int64)
    rc = lib.nr_golden_params(
        BG, A, G, Q_m, N_L, rv_id, I_LBRM,
        -1 if TBS_LBRM is None else TBS_LBRM,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if rc != 0:
        raise RuntimeError(f"nr_golden_params failed with code {rc}")
    keys = ("C", "K_prime", "K_b", "Z_c", "i_LS", "K", "N", "B")
    return dict(zip(keys, out.tolist()))


def golden_decode_core(
    BG: int,
    Z: int,
    llr: np.ndarray,
    iterations: int = 50,
    algorithm: str = "min-sum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    return_totals: bool = False,
):
    """Flooding BP decode with the native oracle.

    llr: (..., n_cols*Z) float32 lifted-layout channel LLRs.  Returns
    (bits, parity_ok, iterations_used[, totals]) with the same leading
    shape.  Bit-exact vs ops.decoder_fast.decode, ops.decoder.decode and
    the flooding kernels for all three rules (bits, parity flags,
    iteration counts; sum-product through the phi recipe of
    ``golden_phi``); the posterior totals come back with
    ``return_totals=True``.  See nr_golden_decode_core in
    native/golden.cpp for the full contract.
    """
    lib = load()
    algo = _ALGO[algorithm]
    llr = np.ascontiguousarray(np.asarray(llr, dtype=np.float32))
    nv = N_COLS[BG] * Z
    if llr.shape[-1] != nv:
        raise ValueError(
            f"BG{BG} Z={Z} expects the full lifted layout of {nv} LLRs "
            f"({N_COLS[BG]}*Z, including the 2Z punctured columns); "
            f"got {llr.shape[-1]}"
        )
    flat = llr.reshape(-1, nv)
    bits = np.zeros_like(flat, dtype=np.uint8)
    totals = np.zeros_like(flat, dtype=np.float32)
    ok = np.zeros(flat.shape[0], dtype=np.int32)
    used = np.zeros(flat.shape[0], dtype=np.int32)
    one_ok = ctypes.c_int(0)
    one_used = ctypes.c_int(0)
    for i in range(flat.shape[0]):
        rc = lib.nr_golden_decode_core(
            BG, Z, iterations, algo,
            ctypes.c_float(alpha), ctypes.c_float(beta),
            flat[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            bits[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(one_ok), ctypes.byref(one_used),
            totals[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise RuntimeError(f"nr_golden_decode_core failed with code {rc}")
        ok[i] = one_ok.value
        used[i] = one_used.value
    shape = llr.shape[:-1]
    out = (
        bits.reshape(llr.shape),
        ok.astype(bool).reshape(shape),
        used.reshape(shape),
    )
    if return_totals:
        out = out + (totals.reshape(llr.shape),)
    return out


class GoldenHARQState(NamedTuple):
    """Caller-owned HARQ buffers for golden_decode (zeroed = reset)."""

    d_buf: np.ndarray  # (C, N_cb) float32 accumulated channel LLRs
    b_buf: np.ndarray  # (B,) uint8 best-so-far decoded bits
    cb_ok: np.ndarray  # (C,) uint8 latched per-code-block pass flags


class GoldenTBResult(NamedTuple):
    a_hat: np.ndarray  # (A,) decoded info bits
    tb_ok: bool
    state: GoldenHARQState
    cb_crc_ok: np.ndarray  # (C,) this transmission's CB CRC results
    parity_ok: np.ndarray  # (C,) LDPC parity satisfied per code block
    iterations: np.ndarray  # (C,) BP iterations used per code block


def golden_init_state(BG: int, A: int, G: int, Q_m: int, N_L: int = 1,
                      rv_id: int = 0, I_LBRM: int = 0,
                      TBS_LBRM: Optional[int] = None) -> GoldenHARQState:
    """Fresh (zeroed) HARQ buffers sized from the derived parameters."""
    p = golden_params(BG, A, G, Q_m, N_L, rv_id, I_LBRM, TBS_LBRM)
    n_ref = (3 * TBS_LBRM) // (2 * p["C"]) if (I_LBRM and TBS_LBRM) else p["N"]
    n_cb = min(p["N"], n_ref) if I_LBRM else p["N"]
    return GoldenHARQState(
        d_buf=np.zeros((p["C"], n_cb), np.float32),
        b_buf=np.zeros(p["B"], np.uint8),
        cb_ok=np.zeros(p["C"], np.uint8),
    )


def golden_decode(
    BG: int,
    A: int,
    G: int,
    Q_m: int,
    g_tilde: np.ndarray,
    N_L: int = 1,
    rv_id: int = 0,
    I_LBRM: int = 0,
    TBS_LBRM: Optional[int] = None,
    CBGTI: Sequence[int] = (),
    iterations: int = 50,
    algorithm: str = "min-sum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    state: Optional[GoldenHARQState] = None,
) -> GoldenTBResult:
    """Full TB-level decode of G channel LLRs with the native oracle.

    Independent counterpart of models.decoder.decode_transport_block
    (NRLDPCDecoder.m:133-340): deinterleave, Chase combining, HARQ buffers,
    filler pinning, BP decode, CB-CRC gating, TB CRC.  ``state=None``
    decodes standalone; passing the previous result's state accumulates
    LLRs and latched code blocks across retransmissions (I_HARQ = 1).
    Bit-exact vs the port's chain with the flooding schedule, all three
    rules (repetition count <= 3; see native/golden.cpp).
    """
    lib = load()
    g_tilde = np.ascontiguousarray(np.asarray(g_tilde, dtype=np.float32))
    if g_tilde.shape != (G,):
        raise ValueError(f"expected {G} rate-matched LLRs, got {g_tilde.shape}")
    use_harq = state is not None
    if state is None:
        state = golden_init_state(BG, A, G, Q_m, N_L, rv_id, I_LBRM, TBS_LBRM)
    d_buf = np.ascontiguousarray(state.d_buf, np.float32).copy()
    b_buf = np.ascontiguousarray(state.b_buf, np.uint8).copy()
    cb_ok = np.ascontiguousarray(state.cb_ok, np.uint8).copy()
    C = d_buf.shape[0]
    cbgti = np.ascontiguousarray(np.asarray(list(CBGTI), dtype=np.int32))
    a_hat = np.zeros(A, np.uint8)
    tb_ok = ctypes.c_int(0)
    cb_crc_ok = np.zeros(C, np.uint8)
    parity_ok = np.zeros(C, np.int32)
    iters = np.zeros(C, np.int32)
    rc = lib.nr_golden_decode(
        BG, A, G, Q_m, N_L, rv_id,
        I_LBRM, -1 if TBS_LBRM is None else TBS_LBRM,
        cbgti.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(CBGTI),
        iterations, _ALGO[algorithm],
        ctypes.c_float(alpha), ctypes.c_float(beta),
        g_tilde.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(use_harq),
        d_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cb_ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a_hat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(tb_ok),
        cb_crc_ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        parity_ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if rc != 0:
        raise RuntimeError(f"nr_golden_decode failed with code {rc}")
    return GoldenTBResult(
        a_hat=a_hat,
        tb_ok=bool(tb_ok.value),
        state=GoldenHARQState(d_buf=d_buf, b_buf=b_buf, cb_ok=cb_ok),
        cb_crc_ok=cb_crc_ok.astype(bool),
        parity_ok=parity_ok.astype(bool),
        iterations=iters,
    )
