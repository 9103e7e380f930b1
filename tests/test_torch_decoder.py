"""The port's layered decoder against the JAX package on the same numpy LLRs.

Bits, ``parity_ok`` and ``iterations`` are held equal (tolerance 0); the
flooding schedule, sum-product and bfloat16 messages are in
``test_torch_flooding.py``.  The JAX layered decoder compiles slowly on the CPU, so the
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
    for schedule in t_cuda.SCHEDULES:  # sum-product is ported: all-zero LLRs pass
        r = t_cuda.decode(pt, llr, algorithm="sum-product", schedule=schedule)
        assert r.parity_ok.all() and not r.bits.any() and not r.iterations.any()
    assert t_cuda.ALGORITHMS == j_pallas.ALGORITHMS == t_layered.ALGORITHMS
    assert t_cuda.SCHEDULES == j_pallas.SCHEDULES
    with pytest.raises(ValueError, match="float32"):  # as the JAX package
        t_cuda.decode(pt, llr, algorithm="sum-product", message_dtype="bfloat16")
    with pytest.raises(ValueError, match="message_dtype"):
        t_cuda.decode(pt, llr, message_dtype="float16")
    with pytest.raises(ValueError, match="schedule"):
        t_cuda.decode(pt, llr, schedule="zigzag")
    with pytest.raises(ValueError):
        t_cuda.decode(pt, llr, algorithm="sum-product", alpha_schedule=(0.5, 1))
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


def _c_argument_kinds(src, function):
    """ctypes kinds of the arguments of ``extern "C" int function(...)``."""
    decl = re.search(r'extern "C" int %s\((.*?)\)\s*{' % function, src, re.S)
    kinds = []
    for arg in filter(None, (a.strip() for a in decl.group(1).split(","))):
        if "*" in arg:
            kinds.append(ctypes.c_void_p)
        elif arg.startswith("float"):
            kinds.append(ctypes.c_float)
        else:
            assert arg.startswith("int"), arg
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_ctypes_signature_matches_the_cuda_source(schedule):
    """The wrapper's argtypes follow the C declaration in the .cu source."""
    name = t_cuda.KERNEL_NAMES[schedule]
    with open(os.path.join(kernels_build.CSRC_DIR, name + ".cu")) as f:
        src = f.read()
    for fn, argtypes in t_cuda.ARGTYPES[name].items():
        assert _c_argument_kinds(src, f"{name}_{fn}") == list(argtypes), fn
    assert t_cuda.ARGTYPES["ldpc_layered"]["decode"] == t_cuda.DECODE_ARGTYPES
    assert t_cuda.ARGTYPES["ldpc_flooding"]["decode"] == t_cuda.FLOODING_DECODE_ARGTYPES
    if schedule == "flooding":
        assert _c_argument_kinds(src, "ldpc_phi") == list(t_cuda.PHI_ARGTYPES)
    # the rule codes are the header's
    with open(os.path.join(kernels_build.CSRC_DIR, "ldpc_bp.cuh")) as f:
        header = f.read()
    for rule, code in t_cuda._RULE_CODES.items():
        macro = "RULE_" + rule.upper().replace("-", "_")
        assert re.search(r"#define %s %d\b" % (macro, code), header), rule
    assert "-fmad=false" in kernels_build.NVCC_FLAGS
    assert "--use_fast_math" not in kernels_build.NVCC_FLAGS
    assert kernels_build.kernel_names() == sorted(
        [*t_cuda.KERNEL_NAMES.values(), "op_rates"])
    assert set(t_cuda.LAUNCHES) == set(t_cuda.KERNEL_NAMES.values())
    assert "arch=compute_90a,code=sm_90a" in kernels_build.NVCC_FLAGS


def test_library_name_follows_source_and_shared_header(tmp_path, monkeypatch):
    """A change to a kernel's source or to the shared header gives the
    library another name, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "common.cuh").write_text("// header\n")
    monkeypatch.setattr(kernels_build, "CSRC_DIR", str(csrc))
    first = kernels_build.library_path("k")
    assert first == kernels_build.library_path("k")
    (csrc / "common.cuh").write_text("// header, edited\n")
    second = kernels_build.library_path("k")
    (csrc / "k.cu").write_text("// kernel, edited\n")
    third = kernels_build.library_path("k")
    assert len({first, second, third}) == 3


CARD_CASES = {
    "layered_min_sum": dict(),
    "layered_sum_product": dict(algorithm="sum-product"),
    "layered_bfloat16": dict(message_dtype="bfloat16"),
    "flooding_sum_product": dict(schedule="flooding", algorithm="sum-product"),
    "flooding_min_sum_alpha_schedule": dict(
        schedule="flooding", alpha_schedule=(0.65, 2)),
    "flooding_offset_budget": dict(
        schedule="flooding", algorithm="offset-min-sum", early_termination=False),
    "flooding_bfloat16": dict(schedule="flooding", message_dtype="bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_matches_plain_on_the_card(name):
    """Each CUDA kernel instantiation equals its plain version (needs a GPU
    and nvcc).  Tolerance 0, sum-product included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    kw = CARD_CASES[name]
    pt = TParams(**Z52)
    llr = torch.from_numpy(_mixed_llrs(pt, seed=3)).cuda()
    kernel = t_cuda.KERNEL_NAMES[kw.get("schedule", "layered")]
    before = dict(t_cuda.LAUNCHES)
    got = t_cuda.decode(pt, llr, iterations=8, **kw)
    assert t_cuda.LAUNCHES[kernel] == before[kernel] + 1
    assert sum(t_cuda.LAUNCHES.values()) == sum(before.values()) + 1
    want = t_cuda.decode_plain(pt, llr, iterations=8, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_phi_on_the_card_matches_plain():
    """The kernels' phi device function equals the plain ``_phi`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    x = torch.logspace(-9.5, 1.7, 100_000, dtype=torch.float32).cuda()
    got, want = t_cuda.phi_on_device(x), t_decoder._phi(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
