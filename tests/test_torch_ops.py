"""The port's plain tensor ops against the JAX package on the same numpy
inputs.  Tolerance 0 (bit-exact) everywhere except ``esn0_to_variance``
(rtol 1e-6: the two libraries' f32 ``pow`` may differ in the last ulp) and
the AWGN moments (the random streams differ by design)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import channel as j_ch
from ldpc_3gpp_tpu.ops import crc as j_crc
from ldpc_3gpp_tpu.ops import encoder as j_enc
from ldpc_3gpp_tpu.ops import modulation as j_mod
from ldpc_3gpp_tpu.ops import rate_match as j_rm
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.ops import channel as t_ch
from ldpc_3gpp_tpu_torch.ops import crc as t_crc
from ldpc_3gpp_tpu_torch.ops import encoder as t_enc
from ldpc_3gpp_tpu_torch.ops import modulation as t_mod
from ldpc_3gpp_tpu_torch.ops import rate_match as t_rm
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.utils.rng import make_generator

torch.set_num_threads(1)


def _eq(jax_out, torch_out):
    """Same dtype, shape and values (tolerance 0)."""
    j = np.asarray(jax_out)
    t = torch_out.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape
    np.testing.assert_array_equal(j, t)


def _pair(**kw):
    return JParams(**kw), TParams(**kw)


@pytest.mark.parametrize("crc,length", [
    ("CRC24A", 8424), ("CRC24B", 1234), ("CRC16", 100), ("None", 50)])
def test_crc_attach_and_check(crc, length):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (3, 2, length)).astype(np.int8)
    bj = j_crc.crc_attach(jnp.asarray(a), crc)
    bt = t_crc.crc_attach(torch.from_numpy(a), crc)
    _eq(bj, bt)
    L = bt.shape[-1] - length
    if L:
        np.testing.assert_array_equal(
            bt[0, 0, length:].numpy(), t_crc.crc_numpy(a[0, 0], crc))
        np.testing.assert_array_equal(
            j_crc.crc_numpy(a[1, 1], crc), t_crc.crc_numpy(a[1, 1], crc))
    if L:  # a half-precision product would lose the parity of large sums
        assert t_crc._table_device(crc, length, True, bt.device).dtype == torch.float32
    bad = bt.clone()
    bad[1, 0, 7] ^= 1
    bad[2, 1, -1] ^= 1
    _eq(j_crc.crc_check(jnp.asarray(bad.numpy()), crc), t_crc.crc_check(bad, crc))
    fails = t_crc.crc_check(bad, crc)
    assert fails.dtype == torch.bool
    assert fails.tolist() == (
        [[False, False], [True, False], [False, True]] if L else [[False] * 2] * 3)


@pytest.mark.parametrize("bg,A,G", [
    (1, 44, 132), (1, 1000, 3000), (1, 8424, 25272),
    (2, 100, 300), (2, 400, 1200), (2, 3842, 11526)])
def test_encode(bg, A, G):
    pj, pt = _pair(BG=bg, A=A, G=G, Q_m=2)
    rng = np.random.default_rng(2)
    c = rng.integers(0, 2, (3, pj.K)).astype(np.int8)
    c[:, pj.K_prime:] = 0
    cw_j = j_enc.encode(pj, jnp.asarray(c))
    cw_t = t_enc.encode(pt, torch.from_numpy(c))
    _eq(cw_j, cw_t)
    syn = t_enc.syndrome(pt, cw_t)
    assert int(syn.sum()) == 0
    _eq(j_enc.syndrome(pj, cw_j ^ 1), t_enc.syndrome(pt, cw_t ^ 1))


RATE_MATCH_CASES = {
    "filler_hole": dict(BG=2, A=100, G=300, Q_m=2),
    "repetition": dict(BG=2, A=100, G=4000, Q_m=2),
    "repetition_3x_k0": dict(BG=2, A=100, G=3300, Q_m=2, rv_id=3),
    "k0_rv2": dict(BG=1, A=1001, G=1500, Q_m=2, rv_id=2),
    "k0_in_hole": dict(BG=2, A=100, G=300, Q_m=2, rv_id=1),
    "lbrm": dict(BG=1, A=4000, G=6000, Q_m=2, I_LBRM=1, TBS_LBRM=4000, rv_id=2),
    "flagship": dict(BG=1, A=8424, G=25272, Q_m=2),
}


@pytest.mark.parametrize("name", sorted(RATE_MATCH_CASES))
def test_select_bits_and_accumulate_llrs(name):
    pj, pt = _pair(**RATE_MATCH_CASES[name])
    E = pj.E_r[0]
    rng = np.random.default_rng(3)
    d = rng.integers(0, 2, (2, pj.N)).astype(np.uint8)
    e_j = j_rm.select_bits(pj, jnp.asarray(d), E)
    e_t = t_rm.select_bits(pt, torch.from_numpy(d), E)
    _eq(e_j, e_t)
    np.testing.assert_array_equal(e_t.numpy(), d[:, t_rm.selection_indices(pt, E)])
    llr = rng.normal(scale=4.0, size=(2, E)).astype(np.float32)
    acc_j = j_rm.accumulate_llrs(pj, jnp.asarray(llr), E)
    acc_t = t_rm.accumulate_llrs(pt, torch.from_numpy(llr), E)
    _eq(acc_j, acc_t)
    assert acc_t.shape == (2, pt.N)


@pytest.mark.parametrize("Q_m", [1, 2, 4, 6])
def test_interleave_deinterleave(Q_m):
    rng = np.random.default_rng(4)
    e = rng.normal(size=(2, 3, 24 * Q_m)).astype(np.float32)
    f_j = j_rm.interleave(jnp.asarray(e), Q_m)
    f_t = t_rm.interleave(torch.from_numpy(e), Q_m)
    _eq(f_j, f_t)
    _eq(j_rm.deinterleave(f_j, Q_m), t_rm.deinterleave(f_t, Q_m))
    np.testing.assert_array_equal(t_rm.deinterleave(f_t, Q_m).numpy(), e)


@pytest.mark.parametrize("modulation", ["BPSK", "QPSK"])
def test_modulate_and_planes(modulation):
    qm = t_mod.Q_M[modulation]
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (3, 48 * qm)).astype(np.uint8)
    s_j = j_mod.modulate(jnp.asarray(bits), modulation)
    s_t = t_mod.modulate(torch.from_numpy(bits), modulation)
    _eq(s_j, s_t)
    np.testing.assert_array_equal(
        s_t[0, :4].numpy(),
        t_mod.constellation(modulation)[
            bits[0, : 4 * qm].reshape(4, qm) @ (1 << np.arange(qm)[::-1])],
    )
    planes = bits.reshape(3, qm, 48)
    _eq(j_mod.modulate_planes(jnp.asarray(planes), modulation),
        t_mod.modulate_planes(torch.from_numpy(planes), modulation))
    _eq(j_mod.modulate(j_rm.interleave(jnp.asarray(bits), qm), modulation),
        t_mod.modulate_planes(torch.from_numpy(planes), modulation))


@pytest.mark.parametrize("modulation", ["BPSK", "QPSK"])
@pytest.mark.parametrize("method", ["exact", "maxlog"])
@pytest.mark.parametrize("var_kind", ["tensor", "float"])
def test_demodulate_and_planes(modulation, method, var_kind):
    rng = np.random.default_rng(6)
    y = (rng.normal(size=(3, 40)) + 1j * rng.normal(size=(3, 40))).astype(np.complex64)
    if var_kind == "tensor":
        nv = np.float32(0.7943282)
        nv_j, nv_t = jnp.asarray(nv), torch.tensor(nv)
    else:
        nv_j = nv_t = 0.63
    _eq(j_mod.demodulate(jnp.asarray(y), modulation, nv_j, method),
        t_mod.demodulate(torch.from_numpy(y), modulation, nv_t, method))
    _eq(j_mod.demodulate_planes(jnp.asarray(y), modulation, nv_j, method),
        t_mod.demodulate_planes(torch.from_numpy(y), modulation, nv_t, method))


def test_unported_modulations_raise():
    """What used to raise as unported now runs (the QAMs, method 'hard');
    unknown names raise ``ValueError`` as in the JAX package."""
    bits = torch.zeros(2, 24, dtype=torch.uint8)
    y = torch.zeros(2, 6, dtype=torch.complex64)
    for modulation in ("16QAM", "64QAM", "256QAM"):
        qm = t_mod.Q_M[modulation]
        assert t_mod.modulate(bits, modulation).shape == (2, 24 // qm)
        assert t_mod.demodulate(y, modulation, 0.5).shape == (2, 6 * qm)
        assert t_mod.demodulate_planes(y, modulation, 0.5).shape == (2, qm, 6)
    hard = t_mod.demodulate(y + 1, "QPSK", 0.5, "hard")
    assert (hard == torch.finfo(torch.float32).max).all()
    with pytest.raises(ValueError):
        t_mod.demodulate(y, "QPSK", 0.5, "nonsense")
    with pytest.raises(ValueError):
        t_mod.modulate(bits, "8PSK")


def test_esn0_to_variance():
    x = np.linspace(-6.0, 12.0, 37).astype(np.float32)
    v_j = np.asarray(j_ch.esn0_to_variance(jnp.asarray(x)))
    v_t = t_ch.esn0_to_variance(torch.from_numpy(x)).numpy()
    assert v_t.dtype == np.float32
    np.testing.assert_allclose(v_t, v_j, rtol=1e-6, atol=0)
    assert t_ch.esn0_to_variance(1.0).shape == ()


def test_awgn_moments():
    """Mean 0 and variance noise_var/2 on each of I and Q.  With n = 2e5
    samples the sample variance has relative sd sqrt(2/n) = 0.32 %, the mean
    sd sqrt(var/n); the bounds are five of those."""
    n, noise_var = 200_000, 0.5
    tx = torch.complex(torch.ones(n), -torch.ones(n))
    rx = t_ch.awgn(make_generator(7, "cpu"), tx, torch.tensor(noise_var))
    assert rx.dtype == torch.complex64 and rx.shape == tx.shape
    noise = (rx - tx)
    for part in (noise.real, noise.imag):
        assert abs(float(part.mean())) < 5 * np.sqrt(noise_var / 2 / n)
        np.testing.assert_allclose(float(part.var()), noise_var / 2, rtol=5 * np.sqrt(2 / n))
    corr = float((noise.real * noise.imag).mean()) / (noise_var / 2)
    assert abs(corr) < 5 / np.sqrt(n)
    again = t_ch.awgn(make_generator(7, "cpu"), tx, torch.tensor(noise_var))
    assert torch.equal(rx, again)
