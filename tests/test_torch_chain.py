"""The port's transport-block chain against the JAX package, end to end, on
the same numpy bits and noise.  Tolerance 0: symbols, LLRs, decoded bits,
flags, HARQ state, every counter and the iteration histogram are equal."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.models import decoder as j_dec
from ldpc_3gpp_tpu.models import encoder as j_enc
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch import convert
from ldpc_3gpp_tpu_torch.models import chain as t_chain
from ldpc_3gpp_tpu_torch.models import decoder as t_dec
from ldpc_3gpp_tpu_torch.models import encoder as t_enc
from ldpc_3gpp_tpu_torch.ops import modulation as t_mod
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.utils.rng import make_generator

torch.set_num_threads(1)

FIELDS = dict(BG=2, A=100, G=300, Q_m=2)
RV_SEQUENCE = (0, 2)
ITERATIONS = 8
BATCH = 24
NOISE_VAR = np.float32(10.0 ** 0.05)  # Es/N0 = -0.5 dB: most blocks need rv 2
DECODE_KW = dict(iterations=ITERATIONS, algorithm="min-sum", schedule="layered")


def _eq(jax_out, torch_out):
    j, t = np.asarray(jax_out), torch_out.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape
    np.testing.assert_array_equal(j, t)


def make_inputs(fields, rv_sequence, batch, noise_var, seed=42):
    """Info bits and per-stage complex noise from a numpy seed."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (batch, fields["A"])).astype(np.int8)
    S = fields["G"] // fields["Q_m"]
    std = np.sqrt(noise_var / 2.0)
    noise = [
        ((rng.standard_normal((batch, S)) + 1j * rng.standard_normal((batch, S)))
         * std).astype(np.complex64)
        for _ in rv_sequence
    ]
    return a, noise


def run_jax_chain(fields, rv_sequence, iterations, noise_var, a, noise, decode_kw):
    """The JAX package's chain, composed from its public functions as
    models/chain.py::simulate_batch composes them, stage by stage."""
    batch = a.shape[0]
    p0 = JParams(**fields)
    nv = jnp.asarray(noise_var)
    state = j_dec.init_harq_state(p0, (batch,))
    stages = []
    success = np.zeros(batch, bool)
    a_hat = np.zeros_like(a)
    total_iters = 0
    hist = np.zeros(iterations + 1, np.int64)
    for stage, rv in enumerate(rv_sequence):
        p = p0.with_tx(rv_id=rv)
        tx = j_enc.encode_to_symbols(p, jnp.asarray(a), "QPSK")
        rx = tx + jnp.asarray(noise[stage])
        d_tilde = j_dec.split_rate_matched_symbols(p, rx, "QPSK", nv, "exact")
        res = jax.jit(partial(
            j_dec.decode_transport_block_d, p, backend="fast",
            iterations=iterations, **decode_kw
        ))(d_tilde, state)
        stages.append(dict(
            state_in=tuple(np.asarray(x) for x in state),
            d_tilde=np.array(d_tilde),
            res={k: np.asarray(v) for k, v in res._asdict().items() if k != "state"},
            state_out=tuple(np.asarray(x) for x in res.state),
        ))
        state = res.state
        tb_ok = np.asarray(res.tb_ok)
        iters = np.asarray(res.iterations)
        newly = tb_ok & ~success
        a_hat = np.where(newly[:, None], np.asarray(res.a_hat), a_hat)
        active = ~success
        success = success | tb_ok
        total_iters += int((iters * active[:, None]).sum())
        hist += np.bincount(iters[active].reshape(-1), minlength=iterations + 1)
    ok = success & (a_hat == a).all(-1)
    return dict(
        stages=stages, tb_ok=ok, block_errors=int((~ok).sum()),
        bit_errors=int(np.where(success[:, None], a_hat != a, True).sum()),
        iterations=total_iters, hist=hist,
    )


def assert_batch_result_equals(r, jax_run, batch):
    """Every counter and flag of a ``BatchResult`` equals the JAX run's."""
    assert int(r.blocks) == batch
    assert int(r.block_errors) == jax_run["block_errors"]
    assert int(r.bit_errors) == jax_run["bit_errors"]
    assert int(r.iterations) == jax_run["iterations"]
    np.testing.assert_array_equal(r.iteration_hist.numpy(), jax_run["hist"])
    np.testing.assert_array_equal(r.tb_ok.numpy(), jax_run["tb_ok"])
    assert r.iteration_hist.dtype == torch.int32 and r.blocks.dtype == torch.int32


def _inputs():
    return make_inputs(FIELDS, RV_SEQUENCE, BATCH, NOISE_VAR)


@pytest.fixture(scope="module")
def jax_run():
    a, noise = _inputs()
    layered_min_sum = {k: v for k, v in DECODE_KW.items() if k != "iterations"}
    return run_jax_chain(
        FIELDS, RV_SEQUENCE, ITERATIONS, NOISE_VAR, a, noise, layered_min_sum)


def _torch_cfg(**kw):
    return t_chain.ChainConfig(
        params=TParams(**FIELDS), modulation="QPSK", rv_sequence=RV_SEQUENCE,
        backend="auto", **DECODE_KW, **kw)


@pytest.mark.parametrize("fields,modulation", [
    (dict(BG=2, A=100, G=300, Q_m=2), "QPSK"),
    (dict(BG=2, A=100, G=600, Q_m=1, rv_id=1), "BPSK"),
    (dict(BG=1, A=20004, G=60012, Q_m=2, CBGTI=(1,)), "QPSK"),
    (dict(BG=1, A=8424, G=25272, Q_m=2), "QPSK"),
])
def test_encode_chain_matches_jax(fields, modulation):
    pj, pt = JParams(**fields), TParams(**fields)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (2, pj.A)).astype(np.int8)
    g_j = j_enc.encode_transport_block(pj, jnp.asarray(a))
    g_t = t_enc.encode_transport_block(pt, torch.from_numpy(a))
    _eq(g_j, g_t)
    tx_j = j_enc.encode_to_symbols(pj, jnp.asarray(a), modulation)
    tx_t = t_enc.encode_to_symbols(pt, torch.from_numpy(a), modulation)
    _eq(tx_j, tx_t)
    assert torch.equal(tx_t, t_mod.modulate(g_t, modulation))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_enc.encode_transport_block(pt, torch.from_numpy(a), backend="mxu")


@pytest.mark.parametrize("fields", [
    dict(BG=2, A=100, G=300, Q_m=2),
    dict(BG=2, A=100, G=4000, Q_m=2, rv_id=3),
    dict(BG=1, A=20004, G=60012, Q_m=2, CBGTI=(1,)),
], ids=["plain", "repetition", "multi_cb_cbgti"])
def test_split_rate_matched_symbols(fields):
    pj, pt = JParams(**fields), TParams(**fields)
    rng = np.random.default_rng(2)
    S = pt.G // 2
    y = (rng.normal(size=(2, S)) + 1j * rng.normal(size=(2, S))).astype(np.complex64)
    nv = np.float32(0.9)
    d_j = j_dec.split_rate_matched_symbols(pj, jnp.asarray(y), "QPSK", jnp.asarray(nv))
    yt = torch.from_numpy(y)
    d_t = t_dec.split_rate_matched_symbols(pt, yt, "QPSK", torch.tensor(nv))
    _eq(d_j, d_t)
    composed = t_dec.split_rate_matched(
        pt, t_mod.demodulate(yt, "QPSK", torch.tensor(nv)))
    assert torch.equal(d_t, composed)
    assert d_t.shape == (2, pt.C, pt.N)


def test_simulate_given_matches_jax(jax_run):
    a, noise = _inputs()
    r = t_chain.simulate_given(
        _torch_cfg(), torch.from_numpy(a), [torch.from_numpy(n) for n in noise],
        torch.tensor(NOISE_VAR))
    assert_batch_result_equals(r, jax_run, BATCH)
    # the point of rv (0, 2): some blocks fail stage 0 and decode at stage 1
    first_ok = jax_run["stages"][0]["res"]["tb_ok"]
    assert 0 < first_ok.sum() < BATCH and jax_run["tb_ok"].sum() > first_ok.sum()


@pytest.mark.parametrize("stage", [0, 1])
def test_decode_transport_block_d_matches_jax_across_harq(jax_run, stage):
    """Each transmission starts from the JAX package's state carried across
    by convert.py, and ends in the same a_hat, flags and state."""
    rec = jax_run["stages"][stage]
    pt = convert.params_from_fields(
        dict(convert.params_to_fields(JParams(**FIELDS)), rv_id=RV_SEQUENCE[stage]))
    assert pt == TParams(**FIELDS).with_rv(RV_SEQUENCE[stage])
    state = convert.harq_state_from_numpy(*rec["state_in"], device="cpu")
    res = t_dec.decode_transport_block_d(
        pt, torch.from_numpy(rec["d_tilde"]), state, backend="auto", **DECODE_KW)
    for name, want in rec["res"].items():
        _eq(want, getattr(res, name))
    for got, want in zip(convert.harq_state_to_numpy(res.state), rec["state_out"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if stage == 0:  # standalone decode (state=None) equals a fresh state
        alone = t_dec.decode_transport_block_d(
            pt, torch.from_numpy(rec["d_tilde"]), None, backend="fast", **DECODE_KW)
        assert torch.equal(alone.a_hat, res.a_hat)
        assert torch.equal(alone.state.d_buf, res.state.d_buf)


def test_decode_transport_block_from_rate_matched_llrs():
    pt = TParams(**FIELDS)
    a, _ = _inputs()
    g = t_enc.encode_transport_block(pt, torch.from_numpy(a))
    llr = 4.0 * (1.0 - 2.0 * g.to(torch.float32))
    res = t_dec.decode_transport_block(pt, llr, backend="auto", **DECODE_KW)
    assert res.tb_ok.all() and torch.equal(res.a_hat, torch.from_numpy(a))
    assert res.iterations.shape == (BATCH, pt.C) and (res.iterations < 4).all()


def test_unported_decoder_options_raise():
    """What used to raise as unported now runs (the defaults, flooding,
    sum-product, bfloat16 messages) or raises what the JAX package raises;
    backend 'reference' is still to port."""
    pt = TParams(**FIELDS)
    a, _ = _inputs()
    g = t_enc.encode_transport_block(pt, torch.from_numpy(a[:2]))
    d = t_dec.split_rate_matched(pt, 4.0 * (1.0 - 2.0 * g.to(torch.float32)))
    want = torch.from_numpy(a[:2])
    for kw in (
        dict(),  # defaults: sum-product, flooding
        dict(algorithm="min-sum", schedule="flooding"),
        dict(algorithm="sum-product", schedule="layered"),
        dict(message_dtype="bfloat16", backend="auto", **DECODE_KW),
        dict(message_dtype="bfloat16", backend="auto", iterations=ITERATIONS,
             algorithm="offset-min-sum", schedule="flooding"),
    ):
        res = t_dec.decode_transport_block_d(pt, d, **kw)
        assert res.tb_ok.all() and torch.equal(res.a_hat, want), kw
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_dec.decode_transport_block_d(pt, d, backend="reference", **DECODE_KW)
    with pytest.raises(ValueError, match="f32-only"):  # as the JAX package
        t_dec.decode_transport_block_d(
            pt, d, message_dtype="bfloat16", backend="fast", **DECODE_KW)
    with pytest.raises(ValueError, match="float32"):
        t_dec.decode_transport_block_d(
            pt, d, message_dtype="bfloat16", backend="auto")  # sum-product
    with pytest.raises(ValueError, match="min-sum only"):
        t_dec.decode_transport_block_d(
            pt, d, backend="auto", alpha_schedule=(0.65, 2))  # sum-product
    with pytest.raises(ValueError, match="alpha_schedule"):
        t_dec.decode_transport_block_d(
            pt, d, backend="fast", algorithm="min-sum", schedule="flooding",
            alpha_schedule=(0.65, 2))
    with pytest.raises(ValueError, match="schedule"):
        t_dec.decode_transport_block_d(pt, d, backend="fast", schedule="zigzag")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_dec.decode_transport_block_d(pt, d, backend="cuda", **DECODE_KW)
    with pytest.raises(ValueError):
        t_dec.decode_transport_block_d(pt, d, backend="nonsense", **DECODE_KW)


def test_simulate_batch_is_deterministic_and_counts_the_batch():
    cfg = _torch_cfg()
    r1 = t_chain.simulate_batch(cfg, make_generator(3, "cpu"), -3.0, 70, device="cpu")
    r2 = t_chain.simulate_batch(cfg, make_generator(3, "cpu"), -3.0, 70, device="cpu")
    r3 = t_chain.simulate_batch(cfg, make_generator(4, "cpu"), -3.0, 70, device="cpu")
    assert int(r1.blocks) == 70 and r1.tb_ok.shape == (70,)  # no padding to 128
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    assert not torch.equal(r1.iteration_hist, r3.iteration_hist)
    assert int(r1.block_errors) == int((~r1.tb_ok).sum())
    assert int(r1.iteration_hist.sum()) >= 70
    assert int((r1.iteration_hist * torch.arange(ITERATIONS + 1)).sum()) == int(r1.iterations)


def test_chain_config_checks_and_cbgti_sequence():
    with pytest.raises(AssertionError):
        t_chain.ChainConfig(params=TParams(**FIELDS), modulation="BPSK")
    p = TParams(BG=1, A=20004, G=60012, Q_m=2)
    cfg = t_chain.ChainConfig(
        params=p, rv_sequence=(0, 2), cbgti_sequence=((), (0, 2)))
    assert cfg.stage_params(0).E_r == p.E_r
    assert cfg.stage_params(1).CBGTI == (0, 2) and cfg.stage_params(1).rv_id == 2
    assert hash(cfg) == hash(t_chain.ChainConfig(
        params=p, rv_sequence=(0, 2), cbgti_sequence=[[], [0, 2]]))
