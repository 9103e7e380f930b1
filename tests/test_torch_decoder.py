"""The port's layered decoder against the JAX package on the same numpy LLRs.

Min-sum family: bits, ``parity_ok`` and ``iterations`` are held equal
(tolerance 0).  The JAX layered decoder compiles slowly on the CPU, so the
JAX-side cases are few and small; each combines several of the options.  On
the CPU ``decoder_cuda.decode`` runs its plain version; the CUDA kernel
itself is compared with that plain version on the card by ``chip_smoke.py``
and by the ``cuda``-marked test here.
"""
import ctypes
import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder_layered as j_layered
from ldpc_3gpp_tpu.ops import decoder_pallas as j_pallas
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch import kernels_build
from ldpc_3gpp_tpu_torch.ops import decoder as t_decoder
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.ops import decoder_layered as t_layered
from ldpc_3gpp_tpu_torch.ops import encoder as t_enc
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams

torch.set_num_threads(1)

Z20 = dict(BG=2, A=100, G=300, Q_m=2)  # Z=20, fillers
Z52 = dict(BG=2, A=400, G=1200, Q_m=2)  # Z=52


def _codeword_llrs(pt, n, sigma, seed):
    """(n, nc*Z) f32 LLRs of random codewords over BPSK-like AWGN, fillers
    pinned and the 2Z punctured positions zero, as the chain builds them."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (n, pt.K)).astype(np.int8)
    c[:, pt.K_prime:] = 0
    cw = t_enc.encode(pt, torch.from_numpy(c)).numpy().astype(np.float32)
    y = (1.0 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = (2.0 * y / sigma**2).astype(np.float32)
    llr[:, : 2 * pt.Z_c] = 0.0
    llr[:, pt.K_prime : pt.K] = t_cuda.FILLER_LLR
    return llr, c


def _mixed_llrs(pt, seed):
    """Codewords that converge at various sweeps plus rows of pure noise
    that never converge."""
    good, _ = _codeword_llrs(pt, 6, 0.75, seed)
    rng = np.random.default_rng(seed + 100)
    junk = rng.normal(scale=2.0, size=(2, good.shape[1])).astype(np.float32)
    junk[:, : 2 * pt.Z_c] = 0.0
    junk[:, pt.K_prime : pt.K] = t_cuda.FILLER_LLR
    return np.concatenate([good, junk])


def _assert_result_equal(rj, rt):
    for name in ("bits", "parity_ok", "iterations"):
        j = np.asarray(getattr(rj, name))
        t = getattr(rt, name).numpy()
        assert j.dtype == t.dtype, (name, j.dtype, t.dtype)
        assert j.shape == t.shape, name
        np.testing.assert_array_equal(j, t, err_msg=name)


LAYERED_CASES = {
    "z20_minsum_et_reversed": (Z20, dict(iterations=8)),
    "z52_offset_et_natural": (
        Z52, dict(iterations=6, algorithm="offset-min-sum", layer_order="natural")),
    "z20_minsum_budget": (Z20, dict(iterations=5, early_termination=False)),
    "z52_minsum_alpha_schedule": (
        Z52, dict(iterations=6, alpha=0.8, alpha_schedule=(0.65, 2))),
    "z20_zero_iterations": (Z20, dict(iterations=0)),
}


@pytest.mark.parametrize("name", sorted(LAYERED_CASES))
def test_layered_decode_matches_jax(name):
    fields, kw = LAYERED_CASES[name]
    pj, pt = JParams(**fields), TParams(**fields)
    llr = _mixed_llrs(pt, seed=len(name))
    rj = jax.jit(partial(j_layered.decode, pj, **kw))(jnp.asarray(llr))
    rt = t_layered.decode(pt, torch.from_numpy(llr), **kw)
    _assert_result_equal(rj, rt)
    assert isinstance(rt, t_decoder.DecodeResult)
    if kw["iterations"] and kw.get("early_termination", True):
        ok = rt.parity_ok.numpy()
        assert ok[:6].any() and not ok[6:].any()  # both outcomes are exercised
        assert (rt.iterations.numpy()[~ok] == kw["iterations"]).all()


def test_decoder_cuda_on_cpu_matches_jax_kernel_interpreted():
    """'d' input and 'sys' output, against the TPU kernel in interpret mode."""
    pj, pt = JParams(**Z20), TParams(**Z20)
    full = _mixed_llrs(pt, seed=31)
    d = np.ascontiguousarray(full[:3, 2 * pt.Z_c :])
    lo, hi = pt.filler_range_d
    d[:, lo:hi] = 0.0  # the raw buffer: fillers NOT pinned
    kw = dict(iterations=4, channel_format="d", output_format="sys")
    rj = jax.jit(partial(j_pallas.decode, pj, interpret=True, **kw))(jnp.asarray(d))
    rt = t_cuda.decode(pt, torch.from_numpy(d), **kw)
    assert rt.bits.shape == (3, pt.K)
    _assert_result_equal(rj, rt)


@pytest.mark.parametrize("fields", [Z20, Z52], ids=["z20", "z52"])
def test_decode_plain_formats_agree(fields):
    """'d'/'sys' equals the 'cw' path's K-bit prefix; batch shapes carry."""
    pt = TParams(**fields)
    full = torch.from_numpy(_mixed_llrs(pt, seed=5)).reshape(2, 4, -1)
    d = full[..., 2 * pt.Z_c :].clone()
    lo, hi = pt.filler_range_d
    d[..., lo:hi] = 0.0
    r_cw = t_cuda.decode(pt, full, iterations=6)
    r_d = t_cuda.decode(pt, d, iterations=6, channel_format="d", output_format="sys")
    assert r_cw.bits.shape == (2, 4, pt.num_cols * pt.Z_c)
    assert r_d.bits.shape == (2, 4, pt.K)
    assert torch.equal(r_d.bits, r_cw.bits[..., : pt.K])
    assert torch.equal(r_d.parity_ok, r_cw.parity_ok)
    assert torch.equal(r_d.iterations, r_cw.iterations)
    r_l = t_layered.decode(pt, full, iterations=6)
    assert torch.equal(r_l.bits, r_cw.bits)


def test_flagship_shape_decodes():
    """BG1 Z=384, a handful of codewords at moderate noise: all decode."""
    pt = TParams(BG=1, A=8424, G=25272, Q_m=2)
    assert pt.Z_c == 384 and pt.num_filler == 0
    llr, c = _codeword_llrs(pt, 3, 0.6, seed=9)
    r = t_cuda.decode(pt, torch.from_numpy(llr[:, 2 * 384 :]), iterations=12,
                      channel_format="d", output_format="sys")
    assert r.parity_ok.all()
    assert (r.iterations < 12).all()
    np.testing.assert_array_equal(r.bits.numpy(), c)
    assert r.bits.dtype == torch.int8 and r.iterations.dtype == torch.int32


@pytest.mark.slow
def test_flagship_shape_matches_jax():
    """BG1 Z=384, 12 iterations, near the waterfall: equal to the JAX layered
    decoder (slow tier: the JAX side compiles for minutes on the CPU)."""
    fields = dict(BG=1, A=8424, G=25272, Q_m=2)
    pj, pt = JParams(**fields), TParams(**fields)
    llr = np.concatenate([  # some converge in 7-8 sweeps, some never
        _codeword_llrs(pt, 3, 1.05, seed=17)[0], _codeword_llrs(pt, 3, 1.1, seed=18)[0]])
    rj = jax.jit(partial(j_layered.decode, pj, iterations=12))(jnp.asarray(llr))
    rt = t_layered.decode(pt, torch.from_numpy(llr), iterations=12)
    _assert_result_equal(rj, rt)
    assert len(set(rt.iterations.tolist())) > 1  # a mix of sweep counts
    assert rt.parity_ok.any() and not rt.parity_ok.all()


def test_layer_order_and_argument_checks():
    pt = TParams(**Z20)
    nr = pt.num_rows
    assert t_cuda._resolve_layer_order(pt, "reversed") == tuple(range(nr - 1, -1, -1))
    assert t_cuda._resolve_layer_order(pt, "natural") == tuple(range(nr))
    with pytest.raises(ValueError):
        t_cuda._resolve_layer_order(pt, (0, 0, 1))
    llr = torch.zeros(2, pt.num_cols * pt.Z_c)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_cuda.decode(pt, llr, algorithm="sum-product")
    with pytest.raises(ValueError):
        t_cuda.decode(pt, llr, algorithm="nonsense")
    with pytest.raises(ValueError):
        t_cuda.decode(pt, llr, channel_format="d")  # wrong width for 'd'
    with pytest.raises(ValueError):
        t_cuda.decode(pt, llr, output_format="parity")
    with pytest.raises(ValueError):
        t_cuda.decode(pt, llr, algorithm="offset-min-sum", alpha_schedule=(0.5, 1))
    assert t_cuda.supports(pt)
    assert t_cuda.FILLER_LLR == j_pallas.FILLER_LLR


def test_graph_plan_covers_every_edge_in_row_order():
    pt = TParams(**Z52)
    order = t_cuda._resolve_layer_order(pt, "reversed")
    edges, row_start, max_deg = t_cuda._graph_plan(pt, order)
    rows, cols, shifts = pt.edges
    Z = pt.Z_c
    assert edges.dtype == np.int32 and edges.shape == (len(rows), 4)
    assert row_start[0] == 0 and row_start[-1] == len(rows)
    assert sorted(edges[:, 2] // Z) == list(range(len(rows)))
    for k, r in enumerate(order):
        seg = edges[row_start[k] : row_start[k + 1]]
        ids = seg[:, 2] // Z
        assert (rows[ids] == r).all()
        np.testing.assert_array_equal(seg[:, 0], cols[ids] * Z)
        np.testing.assert_array_equal(seg[:, 1], shifts[ids])
    assert max_deg == max(np.bincount(rows))


def test_ctypes_signature_matches_the_cuda_source():
    """The wrapper's argtypes follow the C declaration in the .cu source."""
    path = os.path.join(kernels_build.CSRC_DIR, t_cuda.KERNEL_NAME + ".cu")
    with open(path) as f:
        src = f.read()
    decl = re.search(r'extern "C" int ldpc_layered_decode\((.*?)\)\s*{', src, re.S)
    kinds = []
    for arg in decl.group(1).split(","):
        arg = arg.strip()
        if "*" in arg:
            kinds.append(ctypes.c_void_p)
        elif arg.startswith("float"):
            kinds.append(ctypes.c_float)
        else:
            assert arg.startswith("int"), arg
            kinds.append(ctypes.c_int)
    assert kinds == list(t_cuda.DECODE_ARGTYPES)
    assert "-fmad=false" in kernels_build.NVCC_FLAGS
    assert "--use_fast_math" not in kernels_build.NVCC_FLAGS
    assert kernels_build.kernel_names() == [t_cuda.KERNEL_NAME]
    assert "arch=compute_90a,code=sm_90a" in kernels_build.NVCC_FLAGS


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel equals its plain version (needs a GPU and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    pt = TParams(**Z52)
    llr = torch.from_numpy(_mixed_llrs(pt, seed=3)).cuda()
    before = t_cuda.LAUNCHES
    got = t_cuda.decode(pt, llr, iterations=8)
    assert t_cuda.LAUNCHES == before + 1
    want = t_cuda.decode_plain(pt, llr, iterations=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
