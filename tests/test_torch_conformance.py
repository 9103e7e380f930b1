"""The port against the independent C++ oracle (native/golden.cpp), through
the port's own copy of its wrapper (``ldpc_3gpp_tpu_torch.utils.golden``,
built into the port's build directory).

The pattern of tests/test_conformance.py: random configurations drawn as
testbench.m draws them, the encode chain bit-exact against
``golden_encode``, the flooding decoders (the plain one and the segment-op
``'reference'``) bit-exact against ``golden_decode_core`` for all three
rules, and the transport-block decode with HARQ against ``golden_decode``.
Everything runs on the CPU; no JAX is compiled.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu_torch.models.decoder import (
    FILLER_LLR,
    decode_transport_block,
    init_harq_state,
    split_rate_matched,
)
from ldpc_3gpp_tpu_torch.models.encoder import encode_transport_block
from ldpc_3gpp_tpu_torch.ops import decoder as ref_decoder
from ldpc_3gpp_tpu_torch.ops import decoder_fast
from ldpc_3gpp_tpu_torch.ops.decoder import _phi
from ldpc_3gpp_tpu_torch.ops.modulation import demodulate, modulate
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.spec.tables import UnsupportedParameters
from ldpc_3gpp_tpu_torch.utils import golden

torch.set_num_threads(1)

ALGORITHMS = ("min-sum", "offset-min-sum", "sum-product")
MOD_BY_QM = {1: "BPSK", 2: "QPSK", 4: "16QAM", 6: "64QAM", 8: "256QAM"}


def _random_config(rng, max_a=12000):
    """Random draw mirroring testbench.m:21-36 (bounded A for test speed)."""
    R = rng.uniform(0.2, 0.95)
    A = int(rng.integers(1, max_a))
    Q_m = int(rng.choice([1, 2, 4, 6, 8]))
    N_L = int(rng.integers(1, 5))
    rv_id = int(rng.integers(0, 4))
    I_LBRM = int(rng.integers(0, 2))
    TBS_LBRM = int(rng.integers(A, 2 * A + 1)) if I_LBRM else None
    # BG selection rule (testbench.m:26-30)
    BG = 2 if (A <= 292 or (A <= 3824 and R <= 0.67) or R <= 0.25) else 1
    G = int(round(A / R / (N_L * Q_m)) * N_L * Q_m)
    return dict(
        BG=BG, A=A, G=G, Q_m=Q_m, N_L=N_L, rv_id=rv_id,
        I_LBRM=I_LBRM, TBS_LBRM=TBS_LBRM,
    )


def _draw_params(rng, **limits):
    while True:
        kw = _random_config(rng, **limits)
        try:
            return kw, LDPCParams(**kw)
        except UnsupportedParameters:
            continue


def _golden_g(p, a, kw=None):
    kw = kw or dict(N_L=p.N_L, rv_id=p.rv_id, I_LBRM=p.I_LBRM,
                    TBS_LBRM=p.TBS_LBRM, CBGTI=p.CBGTI)
    return golden.golden_encode(p.BG, p.A, p.G, p.Q_m, a, **kw)


def _port_g(p, a, backend="rolls"):
    g = encode_transport_block(p, torch.from_numpy(a[None].astype(np.int8)), backend)
    return g[0].numpy()


def test_oracle_builds_outside_native():
    path = golden.library_path()
    assert "native" not in path and path.endswith(".so")
    golden.load()
    assert path.startswith(golden.BUILD_DIR)


def test_oracle_needs_a_source_checkout(monkeypatch, tmp_path):
    monkeypatch.setattr(golden, "_NATIVE_DIR", str(tmp_path / "absent"))
    monkeypatch.setattr(golden, "_lib", None)
    with pytest.raises(RuntimeError, match="source checkout"):
        golden.load()


def test_params_match_oracle():
    rng = np.random.default_rng(2024)
    checked = 0
    for _ in range(200):
        kw = _random_config(rng)
        try:
            p = LDPCParams(**kw)
        except UnsupportedParameters:
            continue
        gp = golden.golden_params(
            kw["BG"], kw["A"], kw["G"], kw["Q_m"], kw["N_L"], kw["rv_id"],
            kw["I_LBRM"], kw["TBS_LBRM"],
        )
        assert (p.C, p.K_prime, p.K_b, p.Z_c, p.i_LS, p.K, p.N, p.B) == (
            gp["C"], gp["K_prime"], gp["K_b"], gp["Z_c"], gp["i_LS"],
            gp["K"], gp["N"], gp["B"],
        ), kw
        checked += 1
    assert checked > 100


@pytest.mark.parametrize("trial", [
    *range(4),
    *(pytest.param(t, marks=pytest.mark.slow) for t in range(4, 40)),
])
def test_encoder_bit_exact_vs_oracle(trial):
    rng = np.random.default_rng(500 + trial)
    kw, p = _draw_params(rng)
    a = rng.integers(0, 2, p.A, dtype=np.uint8)
    np.testing.assert_array_equal(_port_g(p, a), _golden_g(p, a))


@pytest.mark.parametrize("fields", [
    # several code blocks (CRC24B per block), every layer count, LBRM
    dict(BG=1, A=20004, G=60012, Q_m=2, rv_id=1),
    dict(BG=1, A=12000, G=36000, Q_m=4, N_L=2, rv_id=3),
    dict(BG=2, A=5000, G=15012, Q_m=6, N_L=3, I_LBRM=1, TBS_LBRM=6000),
    dict(BG=1, A=9000, G=13504, Q_m=8, N_L=4, rv_id=2, I_LBRM=1, TBS_LBRM=9000),
    dict(BG=1, A=20004, G=60012, Q_m=2, rv_id=2, CBGTI=(1,)),
])
def test_encoder_segmentation_layers_lbrm_cbgti_vs_oracle(fields):
    p = LDPCParams(**fields)
    rng = np.random.default_rng(p.A)
    a = rng.integers(0, 2, p.A, dtype=np.uint8)
    np.testing.assert_array_equal(_port_g(p, a), _golden_g(p, a))


@pytest.mark.parametrize("fields", [
    dict(BG=2, A=100, G=300, Q_m=2, rv_id=2),
    dict(BG=1, A=1000, G=3000, Q_m=4),
    dict(BG=2, A=3842, G=11526, Q_m=2, rv_id=3),  # C = 2, CRC24B
])
def test_mxu_encoder_vs_oracle(fields):
    p = LDPCParams(**fields)
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2, p.A, dtype=np.uint8)
    np.testing.assert_array_equal(_port_g(p, a, "mxu"), _golden_g(p, a))


def test_phi_bit_exact_vs_oracle():
    rng = np.random.default_rng(99)
    x = np.concatenate([
        np.float32(10.0) ** rng.uniform(-9, 1.58, 50000).astype(np.float32),
        rng.uniform(1e-9, 38.0, 50000).astype(np.float32),
        np.array([1e-9, 0.0004, 7.998, 7.99881172180175781, 8.0, 38.0],
                 np.float32),
    ]).astype(np.float32)
    np.testing.assert_array_equal(_phi(torch.from_numpy(x)).numpy(), golden.golden_phi(x))


def _symbols_to_llrs(p, g, rng, esn0):
    """The port's modulator, numpy noise, the port's exact demodulator."""
    mod = MOD_BY_QM[p.Q_m]
    var = float(np.float32(10.0 ** (-esn0 / 10.0)))
    tx = modulate(torch.from_numpy(np.asarray(g, np.int8)), mod).numpy()
    noise = rng.normal(0.0, np.sqrt(var / 2), (2,) + tx.shape)
    rx = (tx + noise[0] + 1j * noise[1]).astype(np.complex64)
    return demodulate(torch.from_numpy(rx), mod, var, "exact").numpy()


def _tb_llrs(p, rng, esn0, a=None):
    if a is None:
        a = rng.integers(0, 2, p.A, dtype=np.uint8)
    return a, _symbols_to_llrs(p, _port_g(p, a), rng, esn0)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("bg,A,G,esn0", [
    (2, 100, 300, 1.0),
    pytest.param(2, 640, 1280, -1.0, marks=pytest.mark.slow),
    pytest.param(1, 1000, 3000, 0.5, marks=pytest.mark.slow),
])
def test_decode_core_vs_oracle(algorithm, bg, A, G, esn0):
    """The plain flooding decoder and the segment-op reference against the
    oracle's scalar lifted-adjacency BP: bits, parity flags and iteration
    counts, at tolerance 0, non-converging codewords included."""
    p = LDPCParams(BG=bg, A=A, G=G, Q_m=2)
    rng = np.random.default_rng(bg * 77 + A)
    llrs = [torch.from_numpy(_tb_llrs(p, rng, esn0)[1]) for _ in range(6)]
    d = torch.cat([split_rate_matched(p, x) for x in llrs])  # (6C, N)
    cw = torch.cat([torch.zeros(d.shape[0], 2 * p.Z_c), d], dim=-1)
    cw[:, p.K_prime : p.K] = FILLER_LLR
    gbits, gok, git = golden.golden_decode_core(
        bg, p.Z_c, cw.numpy(), iterations=8, algorithm=algorithm)
    assert len(set(git.tolist())) > 1 or esn0 < 0  # a mix of sweep counts
    for fn in (decoder_fast.decode, ref_decoder.decode):
        res = fn(p, cw, iterations=8, algorithm=algorithm)
        np.testing.assert_array_equal(res.bits.numpy(), gbits)
        np.testing.assert_array_equal(res.parity_ok.numpy(), gok)
        np.testing.assert_array_equal(res.iterations.numpy(), git)


def _assert_tb_equal(res_t, res_c):
    np.testing.assert_array_equal(res_t.a_hat.numpy(), res_c.a_hat)
    assert bool(res_t.tb_ok) == res_c.tb_ok
    np.testing.assert_array_equal(res_t.cb_crc_ok.numpy(), res_c.cb_crc_ok)
    np.testing.assert_array_equal(res_t.parity_ok.numpy(), res_c.parity_ok)
    np.testing.assert_array_equal(res_t.iterations.numpy(), res_c.iterations)
    np.testing.assert_array_equal(res_t.state.d_buf.numpy(), res_c.state.d_buf)
    np.testing.assert_array_equal(res_t.state.b_buf.numpy().ravel(), res_c.state.b_buf)
    np.testing.assert_array_equal(res_t.state.cb_ok.numpy(), res_c.state.cb_ok)


def _decode_both(p, llr, state_t, state_c, algorithm, backend, iterations=8):
    res_t = decode_transport_block(
        p, torch.from_numpy(llr), state=state_t, iterations=iterations,
        algorithm=algorithm, backend=backend)
    res_c = golden.golden_decode(
        p.BG, p.A, p.G, p.Q_m, llr, p.N_L, p.rv_id, p.I_LBRM, p.TBS_LBRM,
        p.CBGTI, iterations=iterations, algorithm=algorithm, state=state_c)
    _assert_tb_equal(res_t, res_c)
    return res_t, res_c


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("trial", [
    *range(3),
    *(pytest.param(t, marks=pytest.mark.slow) for t in range(3, 12)),
])
def test_tb_decode_vs_oracle(trial, backend):
    """Random configuration, one rule per trial, standalone decode."""
    rng = np.random.default_rng(900 + trial)
    kw, p = _draw_params(rng, max_a=4000)
    algorithm = ALGORITHMS[trial % 3]
    _, llr = _tb_llrs(p, rng, float(rng.uniform(0.0, 4.0)))
    _decode_both(p, llr, None, None, algorithm, backend)


def _harq_sequence(p0, stages, algorithm, backend, esn0, seed):
    """One transport block over (rv, G) stages with HARQ on both sides;
    returns the stage at which the oracle first decoded it."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, p0.A, dtype=np.uint8)
    st_t = init_harq_state(p0, device="cpu")
    st_c = golden.golden_init_state(p0.BG, p0.A, p0.G, p0.Q_m)
    decoded_at = None
    for i, (rv, G) in enumerate(stages):
        prv = dataclasses.replace(p0, rv_id=rv, G=G)
        _, llr = _tb_llrs(prv, rng, esn0, a=a)
        res_t, res_c = _decode_both(prv, llr, st_t, st_c, algorithm, backend)
        st_t, st_c = res_t.state, res_c.state
        if res_c.tb_ok and decoded_at is None:
            decoded_at = i
    if decoded_at is not None:
        np.testing.assert_array_equal(res_c.a_hat, a)
    return decoded_at


@pytest.mark.parametrize("algorithm,backend", [
    ("min-sum", "auto"),
    pytest.param("offset-min-sum", "reference", marks=pytest.mark.slow),
    pytest.param("sum-product", "auto", marks=pytest.mark.slow),
])
def test_tb_decode_harq_sequence_vs_oracle(algorithm, backend):
    """IR-HARQ retransmissions: LLR and b_hat buffers track the oracle."""
    p0 = LDPCParams(BG=2, A=1522, G=2284, Q_m=2)  # high rate: fails at rv=0
    stages = [(rv, p0.G) for rv in (0, 2, 3, 1)]
    decoded_at = _harq_sequence(p0, stages, algorithm, backend, 0.5, 41)
    # the sequence must actually exercise combining: no first-shot success
    assert decoded_at not in (None, 0), f"HARQ gain not exercised: {decoded_at}"


@pytest.mark.slow
def test_tb_decode_varying_g_harq_vs_oracle():
    """G (and so E_r and the k_0 read window) differs per retransmission."""
    p0 = LDPCParams(BG=2, A=1522, G=2284, Q_m=2)
    decoded_at = _harq_sequence(
        p0, [(0, 2284), (2, 1530), (3, 3046)], "min-sum", "auto", 0.5, 4111)
    assert decoded_at not in (None, 0), f"HARQ gain not exercised: {decoded_at}"


@pytest.mark.slow
def test_tb_decode_multi_cb_cbgti_vs_oracle():
    """C=3 code blocks with CB-CRC gating, then a retransmission with one
    block excluded by CBGTI: the latched flags and b_hat track the oracle."""
    rng = np.random.default_rng(4242)
    p = LDPCParams(BG=1, A=20004, G=60012, Q_m=2)
    assert p.C == 3
    a, llr = _tb_llrs(p, rng, 1.0)
    res_t, res_c = _decode_both(p, llr, None, None, "min-sum", "auto")
    p2 = LDPCParams(BG=1, A=20004, G=60012, Q_m=2, CBGTI=(1,), rv_id=2)
    _, llr2 = _tb_llrs(p2, rng, 1.0, a=a)
    _decode_both(p2, llr2, res_t.state, res_c.state, "min-sum", "auto")
