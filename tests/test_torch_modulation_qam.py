"""16QAM, 64QAM and 256QAM and the 'hard' method of the port against the JAX
package and the C++ oracle, on the same numpy symbols.

Modulation is bit-exact (the same float32 level table).  'maxlog' and 'hard'
repeat the JAX package's float32 operations one for one and a maximum does
not depend on its order, so they are held at tolerance 0.  'exact' goes
through each library's logsumexp (exp, log and the sum's order differ):
measured here at most 3e-7 of the largest |LLR| of a symbol (3,200 symbols
per QAM, against JAX and against the float64 oracle), held at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import modulation as j_mod
from ldpc_3gpp_tpu.ops import rate_match as j_rm
from ldpc_3gpp_tpu.utils import golden
from ldpc_3gpp_tpu_torch.ops import modulation as t_mod
from ldpc_3gpp_tpu_torch.ops import rate_match as t_rm

torch.set_num_threads(1)

QAMS = ["16QAM", "64QAM", "256QAM"]
EXACT_RTOL = 1e-5  # of the symbol's largest |LLR|, see the module docstring


def _eq(jax_out, torch_out):
    j, t = np.asarray(jax_out), torch_out.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape
    np.testing.assert_array_equal(j, t)


def _symbols(modulation, seed, shape=(3, 40)):
    """Noisy constellation points: LLRs of every size and both signs."""
    rng = np.random.default_rng(seed)
    pts = t_mod.constellation(modulation)
    tx = pts[rng.integers(0, len(pts), shape)]
    noise = 0.25 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    return (tx + noise).astype(np.complex64)


def _noise_var(kind):
    if kind == "tensor":
        nv = np.float32(0.07943282)
        return jnp.asarray(nv), torch.tensor(nv)
    return 0.063, 0.063


@pytest.mark.parametrize("modulation", QAMS)
def test_modulate_and_planes_bit_exact(modulation):
    qm = t_mod.Q_M[modulation]
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (3, 48 * qm)).astype(np.uint8)
    s_t = t_mod.modulate(torch.from_numpy(bits), modulation)
    _eq(j_mod.modulate(jnp.asarray(bits), modulation), s_t)
    assert s_t.dtype == torch.complex64
    np.testing.assert_array_equal(
        s_t[0, :4].numpy(),
        t_mod.constellation(modulation)[
            bits[0, : 4 * qm].reshape(4, qm) @ (1 << np.arange(qm)[::-1])],
    )
    planes = bits.reshape(3, qm, 48)
    p_t = t_mod.modulate_planes(torch.from_numpy(planes), modulation)
    _eq(j_mod.modulate_planes(jnp.asarray(planes), modulation), p_t)
    _eq(j_mod.modulate(j_rm.interleave(jnp.asarray(bits), qm), modulation), p_t)
    assert torch.equal(
        p_t, t_mod.modulate(t_rm.interleave(torch.from_numpy(bits), qm), modulation))
    np.testing.assert_array_equal(
        t_mod._pam_levels(modulation)[0], j_mod._pam_levels(modulation)[0])
    np.testing.assert_array_equal(t_mod._bit_masks(modulation), j_mod._bit_masks(modulation))


@pytest.mark.parametrize("modulation", QAMS)
@pytest.mark.parametrize("method", ["maxlog", "hard"])
@pytest.mark.parametrize("var_kind", ["tensor", "float"])
def test_demodulate_maxlog_and_hard_bit_exact(modulation, method, var_kind):
    y = _symbols(modulation, 6)
    nv_j, nv_t = _noise_var(var_kind)
    d_t = t_mod.demodulate(torch.from_numpy(y), modulation, nv_t, method)
    _eq(j_mod.demodulate(jnp.asarray(y), modulation, nv_j, method), d_t)
    p_t = t_mod.demodulate_planes(torch.from_numpy(y), modulation, nv_t, method)
    _eq(j_mod.demodulate_planes(jnp.asarray(y), modulation, nv_j, method), p_t)
    assert torch.isfinite(d_t).all()
    if method == "hard":
        big = torch.finfo(torch.float32).max
        assert (d_t.abs() == big).all() and (d_t > 0).any() and (d_t < 0).any()


@pytest.mark.parametrize("modulation", ["BPSK", "QPSK"])
def test_demodulate_hard_two_level(modulation):
    """'hard' for BPSK (distances to both points) and QPSK (the PAM path)."""
    y = _symbols(modulation, 7)
    nv_j, nv_t = _noise_var("tensor")
    d_t = t_mod.demodulate(torch.from_numpy(y), modulation, nv_t, "hard")
    _eq(j_mod.demodulate(jnp.asarray(y), modulation, nv_j, "hard"), d_t)
    _eq(j_mod.demodulate_planes(jnp.asarray(y), modulation, nv_j, "hard"),
        t_mod.demodulate_planes(torch.from_numpy(y), modulation, nv_t, "hard"))
    soft = t_mod.demodulate(torch.from_numpy(y), modulation, nv_t, "exact")
    assert torch.equal(d_t > 0, soft >= 0)


def _assert_close_per_symbol(got, want, qm):
    got = np.asarray(got, dtype=np.float64).reshape(-1, qm)
    want = np.asarray(want, dtype=np.float64).reshape(-1, qm)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    worst = (np.abs(got - want) / scale).max()
    assert worst <= EXACT_RTOL, worst


@pytest.mark.parametrize("modulation", QAMS)
def test_demodulate_exact_within_tolerance(modulation):
    qm = t_mod.Q_M[modulation]
    y = _symbols(modulation, 8)
    nv_j, nv_t = _noise_var("tensor")
    d_t = t_mod.demodulate(torch.from_numpy(y), modulation, nv_t, "exact")
    assert d_t.dtype == torch.float32 and torch.isfinite(d_t).all()
    _assert_close_per_symbol(
        d_t.numpy(), j_mod.demodulate(jnp.asarray(y), modulation, nv_j, "exact"), qm)
    want = golden.golden_demodulate(y, modulation, float(nv_t), "exact")
    _assert_close_per_symbol(d_t.numpy(), want, qm)


@pytest.mark.parametrize("modulation", QAMS)
@pytest.mark.parametrize("method", ["exact", "maxlog", "hard"])
def test_planes_equal_the_composition(modulation, method):
    qm = t_mod.Q_M[modulation]
    y = torch.from_numpy(_symbols(modulation, 9))
    nv = torch.tensor(0.05)
    planes = t_mod.demodulate_planes(y, modulation, nv, method)
    composed = t_rm.deinterleave(t_mod.demodulate(y, modulation, nv, method), qm)
    assert planes.shape == (3, qm, 40)
    assert torch.equal(planes.reshape(3, -1), composed)


def test_high_snr_roundtrip_every_qam():
    """Hard decisions of noiseless symbols give the bits back."""
    rng = np.random.default_rng(10)
    for modulation in QAMS:
        qm = t_mod.Q_M[modulation]
        bits = torch.from_numpy(rng.integers(0, 2, (2, 30 * qm)).astype(np.int8))
        for method in ("exact", "maxlog", "hard"):
            llr = t_mod.demodulate(t_mod.modulate(bits, modulation), modulation, 0.01, method)
            assert torch.equal((llr < 0).to(torch.int8), bits), (modulation, method)
