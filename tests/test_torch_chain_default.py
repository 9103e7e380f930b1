"""The port's chain with the default decoder (sum-product, flooding: the
reference's literal comm.LDPCDecoder semantics) against the JAX package on
the same numpy bits and noise, across a two-transmission HARQ sequence.
Tolerance 0: every counter, the iteration histogram and the per-block flags
are equal, and so is each transmission's decode from the same HARQ state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.models import chain as j_chain
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch import convert
from ldpc_3gpp_tpu_torch.models import chain as t_chain
from ldpc_3gpp_tpu_torch.models import decoder as t_dec
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.utils.rng import make_generator
from test_torch_chain import assert_batch_result_equals, make_inputs, run_jax_chain

torch.set_num_threads(1)

RV_SEQUENCE = (0, 2)
ITERATIONS = 8
# (fields, batch, noise variance): one code block at Z=20, and the smallest
# kind of two-code-block transport block there is (BG2, A=3842: C=2, Z=208,
# CRC24A + CRC24B, fillers), both where most blocks need the retransmission
CASES = {
    "one_code_block_z20": (dict(BG=2, A=100, G=300, Q_m=2), 24, np.float32(10.0 ** 0.05)),
    "two_code_blocks_z208": (
        dict(BG=2, A=3842, G=11526, Q_m=2), 6, np.float32(10.0 ** 0.06)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    fields, batch, noise_var = CASES[request.param]
    a, noise = make_inputs(fields, RV_SEQUENCE, batch, noise_var, seed=7)
    jax_run = run_jax_chain(  # no algorithm, no schedule: the JAX defaults
        fields, RV_SEQUENCE, ITERATIONS, noise_var, a, noise, {})
    return fields, batch, noise_var, a, noise, jax_run


def test_simulate_given_default_decoder_matches_jax(case):
    fields, batch, noise_var, a, noise, jax_run = case
    cfg = t_chain.ChainConfig(
        params=TParams(**fields), rv_sequence=RV_SEQUENCE, iterations=ITERATIONS)
    assert (cfg.algorithm, cfg.schedule, cfg.backend) == (
        "sum-product", "flooding", "auto")
    r = t_chain.simulate_given(
        cfg, torch.from_numpy(a), [torch.from_numpy(n) for n in noise],
        torch.tensor(noise_var))
    assert_batch_result_equals(r, jax_run, batch)
    # the point of rv (0, 2): some blocks fail stage 0 and decode at stage 1
    first_ok = jax_run["stages"][0]["res"]["tb_ok"]
    assert first_ok.sum() < batch and jax_run["tb_ok"].sum() > first_ok.sum()


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("backend", ["auto", "fast"])
def test_default_decode_matches_jax_across_harq(case, stage, backend):
    """Each transmission from the JAX package's HARQ state: the kernel
    backend on the CPU (the plain version through 'd'/'sys') and backend
    'fast' both end in the same a_hat, flags, iteration counts and state."""
    fields, _, _, _, _, jax_run = case
    rec = jax_run["stages"][stage]
    pt = TParams(**fields).with_rv(RV_SEQUENCE[stage])
    state = convert.harq_state_from_numpy(*rec["state_in"], device="cpu")
    res = t_dec.decode_transport_block_d(
        pt, torch.from_numpy(rec["d_tilde"]), state, iterations=ITERATIONS,
        backend=backend)
    for name, want in rec["res"].items():
        got = getattr(res, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for got, want in zip(convert.harq_state_to_numpy(res.state), rec["state_out"]):
        np.testing.assert_array_equal(got, want)


def test_default_config_runs_and_carries_across():
    """``ChainConfig(params=...)`` alone runs; its decoder fields have the
    JAX package's names and defaults, so a configuration carries across
    field by field (``convert`` carries the code parameters)."""
    pj = JParams(BG=2, A=100, G=300, Q_m=2)
    pt = convert.params_from_fields(convert.params_to_fields(pj))
    r = t_chain.simulate_batch(
        t_chain.ChainConfig(params=pt), make_generator(0, "cpu"), 2.0, 8, device="cpu")
    assert int(r.blocks) == 8 and int(r.block_errors) == 0
    assert r.iteration_hist.shape == (51,)
    cj = j_chain.ChainConfig(
        params=pj, algorithm="min-sum", schedule="layered",
        message_dtype="bfloat16", alpha_schedule=(0.65, 2), iterations=9)
    fields = {f.name: getattr(cj, f.name) for f in dataclasses.fields(cj)
              if f.name != "params"}
    ct = t_chain.ChainConfig(params=pt, **fields)
    for f in dataclasses.fields(ct):
        if f.name != "params":
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    defaults_j = {f.name: f.default for f in dataclasses.fields(j_chain.ChainConfig)}
    defaults_t = {f.name: f.default for f in dataclasses.fields(t_chain.ChainConfig)}
    assert defaults_j == defaults_t
    r = t_chain.simulate_batch(ct, make_generator(0, "cpu"), 2.0, 8, device="cpu")
    assert int(r.block_errors) == 0
