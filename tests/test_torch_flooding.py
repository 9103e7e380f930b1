"""The port's flooding decoder, sum-product rule and bfloat16 messages
against the JAX package on the same numpy LLRs.

Tolerance 0 everywhere, sum-product included: bits, ``parity_ok`` and
``iterations`` are equal, and ``_phi`` is equal bit for bit (-0.0 included).
The port evaluates phi by an explicit recipe of float32 operations that
reproduces the float32 ``tanh`` and ``log`` JAX evaluates on the CPU.  What
has no plain JAX counterpart is in ``test_torch_kernel_variants.py``.  Small
shapes (Z=20, Z=52), at most 8 iterations; the JAX
side's compiles are the cost.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder as j_decoder
from ldpc_3gpp_tpu.ops import decoder_fast as j_fast
from ldpc_3gpp_tpu.ops import decoder_layered as j_layered
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.ops import decoder as t_decoder
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.ops import decoder_fast as t_fast
from ldpc_3gpp_tpu_torch.ops import decoder_layered as t_layered
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from test_torch_decoder import Z20, Z52, _assert_result_equal, _mixed_llrs

torch.set_num_threads(1)


def test_phi_matches_jax_bit_for_bit():
    """200,000 points: a log grid over and beyond the clamp range
    [1e-9, 38] plus uniform samples; equal bits, so -0.0 equals -0.0."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.exp(np.linspace(np.log(1e-10), np.log(45.0), 150_000)),
        rng.uniform(0.0, 40.0, 49_998), [0.0, 1e20],
    ]).astype(np.float32)
    want = np.asarray(jax.jit(j_decoder._phi)(jnp.asarray(x)))
    got = t_decoder._phi(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (np.signbit(got) & (got == 0)).any()  # -0.0 where tanh saturates
    assert t_decoder._PHI_MIN == j_decoder._PHI_MIN
    assert t_decoder._PHI_MAX == j_decoder._PHI_MAX


FLOODING_CASES = {
    "z20_sum_product_et": (Z20, dict(iterations=8, algorithm="sum-product")),
    "z52_sum_product_budget": (
        Z52, dict(iterations=5, algorithm="sum-product", early_termination=False)),
    "z52_min_sum_et": (Z52, dict(iterations=8, algorithm="min-sum")),
    "z20_min_sum_budget": (
        Z20, dict(iterations=5, algorithm="min-sum", alpha=0.8,
                  early_termination=False)),
    "z20_offset_et": (Z20, dict(iterations=8, algorithm="offset-min-sum")),
    "z52_offset_budget": (
        Z52, dict(iterations=4, algorithm="offset-min-sum", beta=0.3,
                  early_termination=False)),
    "z20_sum_product_zero_iterations": (
        Z20, dict(iterations=0, algorithm="sum-product")),
}


@pytest.mark.parametrize("name", sorted(FLOODING_CASES))
def test_flooding_decode_matches_jax(name):
    fields, kw = FLOODING_CASES[name]
    pj, pt = JParams(**fields), TParams(**fields)
    llr = _mixed_llrs(pt, seed=len(name))
    rj = jax.jit(partial(j_fast.decode, pj, **kw))(jnp.asarray(llr))
    rt = t_fast.decode(pt, torch.from_numpy(llr), **kw)
    _assert_result_equal(rj, rt)
    assert isinstance(rt, t_decoder.DecodeResult)
    ok = rt.parity_ok.numpy()
    if kw["iterations"]:
        assert ok[:6].any() and not ok[6:].any()  # both outcomes are exercised
    if kw["iterations"] and kw.get("early_termination", True):
        used = rt.iterations.numpy()
        assert (used[~ok] == kw["iterations"]).all()
        assert (used[ok] > 0).all() and (used[ok] < kw["iterations"]).all()
    else:
        assert (rt.iterations.numpy() == kw["iterations"]).all()


@pytest.mark.parametrize("fields,kw", [
    (Z20, dict(iterations=6)),
    (Z52, dict(iterations=4, early_termination=False, layer_order="natural")),
], ids=["z20_et_reversed", "z52_budget_natural"])
def test_layered_sum_product_matches_jax(fields, kw):
    pj, pt = JParams(**fields), TParams(**fields)
    llr = _mixed_llrs(pt, seed=23)
    rj = jax.jit(partial(j_layered.decode, pj, algorithm="sum-product", **kw))(
        jnp.asarray(llr))
    rt = t_layered.decode(pt, torch.from_numpy(llr), algorithm="sum-product", **kw)
    _assert_result_equal(rj, rt)
    assert rt.parity_ok[:6].any() and not rt.parity_ok[6:].any()


def _raw_d(pt, full):
    """The raw circular buffer of full codeword LLRs: fillers NOT pinned."""
    d = np.ascontiguousarray(full[:, 2 * pt.Z_c:])
    lo, hi = pt.filler_range_d
    d[:, lo:hi] = 0.0
    return d


@pytest.mark.parametrize("fields", [Z20, Z52], ids=["z20", "z52"])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
def test_flooding_plain_formats_agree(fields, algorithm):
    """Flooding through ``decoder_cuda`` on the CPU: 'd'/'sys' equals the
    'cw' path's K-bit prefix and ``decoder_fast``; batch shapes carry."""
    pt = TParams(**fields)
    full = torch.from_numpy(_mixed_llrs(pt, seed=5)).reshape(2, 4, -1)
    d = torch.from_numpy(_raw_d(pt, full.reshape(8, -1).numpy())).reshape(2, 4, -1)
    kw = dict(iterations=6, algorithm=algorithm, schedule="flooding")
    r_cw = t_cuda.decode(pt, full, **kw)
    r_d = t_cuda.decode(pt, d, channel_format="d", output_format="sys", **kw)
    assert r_cw.bits.shape == (2, 4, pt.num_cols * pt.Z_c)
    assert r_d.bits.shape == (2, 4, pt.K)
    assert torch.equal(r_d.bits, r_cw.bits[..., : pt.K])
    assert torch.equal(r_d.parity_ok, r_cw.parity_ok)
    assert torch.equal(r_d.iterations, r_cw.iterations)
    r_f = t_fast.decode(pt, full, iterations=6, algorithm=algorithm)
    for got, want in zip(r_cw, r_f):
        assert torch.equal(got, want)
    # flooding takes about twice the sweeps of the layered schedule
    r_l = t_cuda.decode(pt, full, iterations=6, algorithm=algorithm)
    assert int(r_l.iterations.sum()) < int(r_cw.iterations.sum())


def test_bfloat16_rounds_only_the_stored_message():
    """One update sweep is unaffected by the message type (the totals take
    the unrounded message); the second sweep subtracts the rounded one."""
    pt = TParams(**Z52)
    llr = torch.from_numpy(_mixed_llrs(pt, seed=9)[6:])  # never converge
    for decode in (t_fast.decode, t_layered.decode):
        one = [decode(pt, llr, iterations=1, early_termination=False,
                      message_dtype=m) for m in ("float32", "bfloat16")]
        assert torch.equal(one[0].bits, one[1].bits)
        many = [decode(pt, llr, iterations=6, early_termination=False,
                       message_dtype=m) for m in ("float32", "bfloat16")]
        assert not torch.equal(many[0].bits, many[1].bits)
    with pytest.raises(ValueError, match="float32"):
        t_fast.decode(pt, llr, algorithm="sum-product", message_dtype="bfloat16")
    with pytest.raises(ValueError, match="min-sum only"):
        t_fast.decode(pt, llr, algorithm="offset-min-sum", alpha_schedule=(0.5, 1))
    with pytest.raises(ValueError, match="algorithm"):
        t_fast.decode(pt, llr, algorithm="nonsense")


def test_flooding_graph_plan_marks_first_edge_of_each_column():
    """The kernels' edge table in ascending row order: exactly one 'first'
    edge per column, and it is the column's lowest row."""
    pt = TParams(**Z52)
    order = tuple(range(pt.num_rows))
    edges, row_start, _ = t_cuda._graph_plan(pt, order)
    rows, cols, _ = pt.edges
    Z = pt.Z_c
    first = edges[edges[:, 3] == 1]
    assert sorted(first[:, 0] // Z) == list(range(pt.num_cols))
    for col_off, _, edge_off, _ in first:
        c, e = col_off // Z, edge_off // Z
        assert cols[e] == c and rows[e] == rows[cols == c].min()
    assert set(np.unique(edges[:, 3])) == {0, 1}
