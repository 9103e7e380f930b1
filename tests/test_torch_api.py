"""The port's System-object-style API: against the JAX API on the same
numpy inputs, and the reference's usage pattern (the cases of
tests/test_api.py) on the CPU.  The AWGN channel's stream differs from the
JAX package's by design, so those cases check outcomes, not noise."""
import numpy as np

from ldpc_3gpp_tpu import api as j_api
from ldpc_3gpp_tpu_torch.api import (
    AWGNChannel,
    NRDemodulator,
    NRLDPCDecoder,
    NRLDPCEncoder,
    NRModulator,
)

RNG = np.random.default_rng(23)
CPU = dict(device="cpu")


def test_round_trip_equals_jax_api():
    """BG2 A=100, min-sum, HARQ over rv 0 and 2 on one transport block: the
    encoder's bits, the symbols and the LLRs are equal; the decoders take
    the same LLRs and return the same a_hat or None at every step."""
    A, G, var = 100, 300, 10 ** 0.05  # Es/N0 = -0.5 dB: rv 0 alone fails
    kw = dict(BG=2, A=A, G=G, Q_m=2)
    dkw = dict(kw, I_HARQ=1, iterations=8, algorithm="min-sum")
    enc_t, enc_j = NRLDPCEncoder(**kw, **CPU), j_api.NRLDPCEncoder(**kw)
    dec_t, dec_j = NRLDPCDecoder(**dkw, **CPU), j_api.NRLDPCDecoder(**dkw)
    mod_t, mod_j = NRModulator("QPSK", **CPU), j_api.NRModulator("QPSK")
    dem_t = NRDemodulator("QPSK", variance=var, **CPU)
    dem_j = j_api.NRDemodulator("QPSK", variance=var)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2, A).astype(np.int8)
    outcomes = []
    for rv in (0, 2):
        enc_t.rv_id = enc_j.rv_id = dec_t.rv_id = dec_j.rv_id = rv
        g = enc_t.step(a)
        np.testing.assert_array_equal(g, enc_j.step(a))
        tx = mod_t.step(g)
        np.testing.assert_array_equal(tx, mod_j.step(g))
        noise = rng.standard_normal((2, tx.size)) * np.sqrt(var / 2)
        rx = (tx + noise[0] + 1j * noise[1]).astype(np.complex64)
        llr = dem_t.step(rx)
        np.testing.assert_array_equal(llr, dem_j.step(rx))
        got, want = dec_t.step(llr), dec_j.step(llr)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, a)
        outcomes.append(got is not None)
    assert outcomes == [False, True], outcomes


def test_reference_driver_loop():
    """Line-for-line port of the plot_BLER_vs_SNR inner loop (single block)."""
    A, G = 1000, 3000
    mod = NRModulator("QPSK", **CPU)
    dem = NRDemodulator("QPSK", **CPU)
    chan = AWGNChannel(snr_db=2.0, seed=1, **CPU)
    enc = NRLDPCEncoder(A=A, BG=1, G=G, Q_m=mod.Q_m, **CPU)
    dec = NRLDPCDecoder(A=A, BG=1, G=G, Q_m=mod.Q_m, I_HARQ=1, iterations=20,
                        **CPU)

    successes = 0
    for trial in range(4):
        a = RNG.integers(0, 2, A).astype(np.int8)
        dec.reset()
        a_hat = None
        for rv in (0,):
            enc.rv_id = rv
            dec.rv_id = rv
            g = enc.step(a)
            assert g.shape == (G,)
            tx = mod.step(g)
            rx = chan.step(tx)
            dem.variance = 10 ** (-2.0 / 10)
            llr = dem.step(rx)
            a_hat = dec.step(llr)
            if a_hat is not None:
                break
        if a_hat is not None and np.array_equal(a_hat, a):
            successes += 1
    assert successes == 4  # 2 dB is well above the waterfall for R=1/3


def test_decode_failure_returns_none():
    A, G = 100, 300
    enc = NRLDPCEncoder(A=A, BG=2, G=G, Q_m=2, **CPU)
    dec = NRLDPCDecoder(A=A, BG=2, G=G, Q_m=2, iterations=5, **CPU)
    a = RNG.integers(0, 2, A).astype(np.int8)
    enc.step(a)
    # garbage LLRs: decode must fail and return None (the reference's [])
    llr = RNG.normal(size=G).astype(np.float32) * 0.1
    assert dec.step(llr) is None


def test_derived_properties_exposed():
    enc = NRLDPCEncoder(A=3842, BG=2, G=11526, Q_m=2, **CPU)
    assert enc.C == 2 and enc.Z_c == 208 and enc.K_prime == 1957
    assert sum(enc.E_r) == enc.G
    enc.rv_id = 2  # tunable, recomputes k_0
    assert enc.k_0 > 0


def test_harq_accumulation_via_api():
    A, G = 100, 300
    mod = NRModulator("QPSK", **CPU)
    enc = NRLDPCEncoder(A=A, BG=2, G=G, Q_m=2, **CPU)
    dec = NRLDPCDecoder(A=A, BG=2, G=G, Q_m=2, I_HARQ=1, iterations=20, **CPU)
    chan = AWGNChannel(snr_db=-1.5, seed=3, **CPU)
    a = RNG.integers(0, 2, A).astype(np.int8)
    g = enc.step(a)
    dec.reset()
    got = None
    for _ in range(5):  # chase retransmissions accumulate in the decoder
        rx = chan.step(mod.step(g))
        dem = NRDemodulator("QPSK", variance=10 ** (1.5 / 10), **CPU)
        got = dec.step(dem.step(rx))
        if got is not None:
            break
    assert got is not None and np.array_equal(got, a)


def test_varying_g_between_harq_steps():
    """G (and rv_id) mutate between retransmissions of one transport block:
    a short first transmission plus a longer, differently-punctured
    retransmission must combine and decode."""
    A = 500
    stages = [(0, 800), (2, 1200)]  # (rv_id, G): rv0 alone fails at 2 dB
    mod = NRModulator("QPSK", **CPU)
    enc = NRLDPCEncoder(A=A, BG=1, G=stages[0][1], Q_m=mod.Q_m, **CPU)
    dec = NRLDPCDecoder(A=A, BG=1, G=stages[0][1], Q_m=mod.Q_m, I_HARQ=1,
                        iterations=12, **CPU)
    chan = AWGNChannel(snr_db=2.0, seed=11, **CPU)
    a = RNG.integers(0, 2, A).astype(np.int8)
    dec.reset()
    got = []
    for rv, G in stages:
        enc.rv_id, enc.G = rv, G
        dec.rv_id, dec.G = rv, G
        g = enc.step(a)
        assert g.shape == (G,)
        rx = chan.step(mod.step(g))
        dem = NRDemodulator("QPSK", variance=10 ** (-2.0 / 10), **CPU)
        got.append(dec.step(dem.step(rx)))
    assert got[0] is None  # high-rate first shot fails...
    assert got[1] is not None and np.array_equal(got[1], a)  # ...IR decodes


def test_batched_step():
    A, G = 100, 300
    enc = NRLDPCEncoder(A=A, BG=2, G=G, Q_m=2, **CPU)
    a = RNG.integers(0, 2, (8, A)).astype(np.int8)
    g = enc.step(a)
    assert g.shape == (8, G)
    dec = NRLDPCDecoder(A=A, BG=2, G=G, Q_m=2, iterations=10, **CPU)
    llr = (1.0 - 2.0 * g).astype(np.float32) * 8.0
    a_hat, ok = dec.step(llr)
    assert ok.all()
    np.testing.assert_array_equal(a_hat, a)


def test_channel_is_reproducible_per_seed():
    tx = np.ones(64, np.complex64)
    r1 = AWGNChannel(snr_db=3.0, seed=5, **CPU).step(tx)
    r2 = AWGNChannel(snr_db=3.0, seed=5, **CPU).step(tx)
    np.testing.assert_array_equal(r1, r2)
    assert r1.dtype == np.complex64 and not np.array_equal(r1, tx)
    # total noise variance 10^(-3/10), split evenly over I and Q
    rx = AWGNChannel(snr_db=3.0, seed=6, **CPU).step(np.zeros(200000, np.complex64))
    assert abs(np.mean(np.abs(rx) ** 2) / 10 ** -0.3 - 1.0) < 0.02
