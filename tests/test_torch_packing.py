"""Several small-Z codewords per block: the wrapper's side of the packed
kernels (which only run on the card), and the port's chain at lifting sizes
below and above the JAX kernel's smallest against the JAX chain."""
import ctypes
import inspect
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.models import decoder as j_dec
from ldpc_3gpp_tpu.models import encoder as j_enc
from ldpc_3gpp_tpu.ops import decoder_pallas as j_pallas
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch import kernels_build
from ldpc_3gpp_tpu_torch.models import decoder as t_dec
from ldpc_3gpp_tpu_torch.models import encoder as t_enc
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.spec.tables import ALL_LIFTING_SIZES
from ldpc_3gpp_tpu_torch.tools import op_rates, small_z
from test_torch_decoder import _c_argument_kinds, _mixed_llrs

torch.set_num_threads(1)

Z20 = dict(BG=2, A=100, G=300, Q_m=2)
Z5 = dict(BG=2, A=14, G=42, Q_m=2)


@pytest.mark.parametrize("schedule", t_cuda.SCHEDULES)
def test_codewords_per_block_changes_no_result(schedule):
    """``decode_plain`` takes the argument and ignores it; ``decode`` on CPU
    tensors checks an explicit value and gives the same result."""
    pt = TParams(**Z20)
    llr = torch.from_numpy(_mixed_llrs(pt, seed=2))
    assert "codewords_per_block" in inspect.signature(t_cuda.decode_plain).parameters
    assert inspect.signature(t_cuda.decode).parameters["codewords_per_block"].default == 0
    kw = dict(iterations=6, schedule=schedule)
    one = t_cuda.decode_plain(pt, llr, codewords_per_block=1, **kw)
    for p in (0, 2, 16):
        for fn in (t_cuda.decode_plain, t_cuda.decode):
            got = fn(pt, llr, codewords_per_block=p, **kw)
            for g, w in zip(got, one):
                assert torch.equal(g, w)
    with pytest.raises(ValueError, match="codewords_per_block"):
        t_cuda.decode(pt, llr, codewords_per_block=32, **kw)  # 640 lanes
    with pytest.raises(ValueError, match="codewords_per_block"):
        t_cuda.decode(pt, llr, codewords_per_block=-1, **kw)


def test_chain_config_carries_codewords_per_block():
    """The knob reaches the kernels' wrapper from ``ChainConfig`` (and so from
    the keyword arguments of ``bler_vs_snr``), changes no counter, and is refused
    by a backend that has no blocks."""
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig, simulate_batch
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    pt = TParams(BG=2, A=100, G=200, Q_m=2)
    base = dict(params=pt, iterations=6, algorithm="min-sum")
    want = simulate_batch(ChainConfig(**base), make_generator(3, "cpu"), 2.0, 16,
                          device="cpu")
    got = simulate_batch(ChainConfig(codewords_per_block=4, **base),
                         make_generator(3, "cpu"), 2.0, 16, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="codewords_per_block"):
        simulate_batch(ChainConfig(codewords_per_block=32, **base),
                       make_generator(3, "cpu"), 2.0, 16, device="cpu")
    with pytest.raises(ValueError, match="knob of the kernels"):
        simulate_batch(ChainConfig(codewords_per_block=4, backend="fast", **base),
                       make_generator(3, "cpu"), 2.0, 16, device="cpu")


def test_automatic_rule_fits_every_lifting_size():
    """For every TS38.212 lifting size and batch: P >= 1, the block within
    its threads and shared memory, one codeword per block from the measured
    cut up, and no packing that would leave the card short of blocks."""
    seen = set()
    for Z in ALL_LIFTING_SIZES:
        params = small_z.table_params(Z)
        assert params.Z_c == Z
        E = len(params.edges[0])
        for schedule in t_cuda.SCHEDULES:
            for n in (1, 256, 2048, 8192, 16384, 65536):
                P = t_cuda.auto_codewords_per_block(params, n, schedule)
                seen.add(P)
                assert P >= 1 and (P == 1 or P in t_cuda.PACK_CHOICES)
                assert -(-(P * Z) // 32) * 32 <= t_cuda.MAX_BLOCK_THREADS
                smem = (t_cuda.flooding_shared_bytes(params, t_cuda.flooding_layout(params))
                        if schedule == "flooding" and P == 1 else
                        t_cuda.shared_bytes(schedule, Z, params.num_cols,
                                            params.num_rows, E, P))
                assert smem <= t_cuda.MAX_BLOCK_SHARED_BYTES == 232_448
                # the measured cuts: no packing above 64 lanes per block, in
                # a launch too small to fill the card, or for full warps
                if 2 * Z > t_cuda.PACK_MAX_LANES or n < 2 * t_cuda.PACK_MIN_BLOCKS \
                        or Z % 32 == 0:
                    assert P == 1
                if P > 1:
                    assert -(-n // P) >= t_cuda.PACK_MIN_BLOCKS
                    assert P * Z <= t_cuda.PACK_MAX_LANES
                assert t_cuda.resolve_codewords_per_block(params, n, schedule, 0) == P
                assert t_cuda.resolve_codewords_per_block(params, n, schedule, 1) == 1
        assert t_cuda.supports(params)
    assert {1, 2, 4, 8, 16} <= seen
    # the sweeps' default calls (256 to 2,048 codewords) are never packed
    z20 = small_z.table_params(20)
    z8, z2 = small_z.table_params(8), small_z.table_params(2)
    for p in (z2, z8, z20):
        for schedule in t_cuda.SCHEDULES:
            assert [t_cuda.auto_codewords_per_block(p, n, schedule)
                    for n in (256, 2048, 4096)] == [1, 1, 1]
    # 20 lanes fill a warp no better two at a time, and four are over the cap
    assert t_cuda.auto_codewords_per_block(z20, 65536, "layered") == 1
    assert [t_cuda.auto_codewords_per_block(z8, n, "layered")
            for n in (8192, 16384, 32768)] == [2, 4, 8]
    # flooding never packs: its one-codeword kernel was as fast as the packed
    # one at the rule's choices
    for p in (z2, z8):
        assert [t_cuda.auto_codewords_per_block(p, n, "flooding")
                for n in (8192, 16384, 65536)] == [1, 1, 1]
    assert [t_cuda.auto_codewords_per_block(z2, n, "layered")
            for n in (16384, 65536)] == [4, 16]


def test_shared_bytes_formula():
    # one codeword per block: the figures of the kernels' notes (BG1 Z=384:
    # one flooding block would need totals, messages and both plans, so a
    # cluster of three blocks holds the codeword)
    p = TParams(BG=1, A=8424, G=25272, Q_m=2)
    E = len(p.edges[0])
    assert t_cuda.shared_bytes("flooding", 384, p.num_cols, p.num_rows, E) == 595_344
    assert t_cuda.flooding_layout(p) == 3 and t_cuda.flooding_shared_bytes(p, 3) == 205_264
    assert t_cuda.shared_bytes("layered", 384, p.num_cols, p.num_rows, E) == 109_692
    assert not t_cuda._fits("flooding", p, 2) and t_cuda._fits("flooding", p, 1)
    # P codewords: P sets of state and P flag words on top of the tables
    q = small_z.table_params(20)
    one = t_cuda.shared_bytes("layered", 20, q.num_cols, q.num_rows, 197)
    four = t_cuda.shared_bytes("layered", 20, q.num_cols, q.num_rows, 197, 4)
    assert four - one == 3 * q.num_cols * 20 * 4 + 16
    # packed flooding: P sets of totals and (on chip) of messages, four vote
    # words per codeword and two per block on top of both plans
    on_chip = t_cuda.shared_bytes("flooding", 20, q.num_cols, q.num_rows, 197, 4)
    assert on_chip == 4 * (q.num_cols + 197) * 20 * 4 + 197 * 16 + (
        q.num_rows + q.num_cols + 2) * 4 + 4 * 16 + 8 == 83_288
    scratch = t_cuda.shared_bytes("flooding", 20, q.num_cols, q.num_rows, 197, 4,
                                  on_chip=False)
    assert on_chip - scratch == 4 * 197 * 20 * 4


def test_ctypes_signatures_of_the_new_entries():
    """The argtypes the wrappers declare follow the C declarations."""
    for name in t_cuda.KERNEL_NAMES.values():
        with open(os.path.join(kernels_build.CSRC_DIR, name + ".cu")) as f:
            src = f.read()
        for fn in ("decode", "shared_bytes", "blocks_per_sm"):
            assert _c_argument_kinds(src, f"{name}_{fn}") == list(t_cuda.ARGTYPES[name][fn])
        assert "codewords_per_block" in src and f"{name}_packed_kernel" in src
    assert t_cuda.ARGTYPES["ldpc_layered"]["shared_bytes"] == [ctypes.c_int] * 5
    assert t_cuda.ARGTYPES["ldpc_layered"]["blocks_per_sm"] == [ctypes.c_int] * 7
    with open(os.path.join(kernels_build.CSRC_DIR, "op_rates.cu")) as f:
        src = f.read()
    assert _c_argument_kinds(src, "op_rates_run") == list(op_rates.RUN_ARGTYPES)
    for fn, value in (("chains", op_rates.CHAINS), ("inner", op_rates.INNER),
                      ("scratch_group", op_rates.SCRATCH_GROUP)):
        assert _c_argument_kinds(src, "op_rates_" + fn) == []
        assert f"#define {fn.upper()} {value}" in src or fn == "scratch_group"
    assert f"#define SCRATCH_GROUP {op_rates.SCRATCH_GROUP}" in src
    for i, op in enumerate(op_rates.CLASSES):
        assert f"#define OP_{op.upper()} {i}" in src
    assert op_rates.KERNEL_NAME in kernels_build.kernel_names()


def _chain_inputs(fields, batch, noise_var, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (batch, fields["A"])).astype(np.int8)
    S = fields["G"] // 2
    noise = ((rng.standard_normal((batch, S)) + 1j * rng.standard_normal((batch, S)))
             * np.sqrt(noise_var / 2)).astype(np.complex64)
    return a, noise


def _jax_decode(fields, a, noise, noise_var, backend, iterations):
    p = JParams(**fields)
    rx = j_enc.encode_to_symbols(p, jnp.asarray(a), "QPSK") + jnp.asarray(noise)
    d = j_dec.split_rate_matched_symbols(p, rx, "QPSK", jnp.asarray(noise_var), "exact")
    return jax.jit(partial(
        j_dec.decode_transport_block_d, p, backend=backend, iterations=iterations,
        algorithm="min-sum", schedule="layered"))(d)


def _torch_decode(fields, a, noise, noise_var, iterations):
    p = TParams(**fields)
    rx = t_enc.encode_to_symbols(p, torch.from_numpy(a), "QPSK") + torch.from_numpy(noise)
    d = t_dec.split_rate_matched_symbols(p, rx, "QPSK", torch.tensor(noise_var))
    return t_dec.decode_transport_block_d(
        p, d, backend="auto", iterations=iterations, algorithm="min-sum",
        schedule="layered")


CHAIN_CASES = {
    "z5_fast": (Z5, "fast"),
    "z20_fast": (Z20, "fast"),
    "z20_kernel_interpreted": (Z20, "pallas-interpret"),
}


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_at_small_z_matches_jax(name):
    """Bits, ``tb_ok``, parity flags and iterations equal the JAX chain's: at
    Z=5 (below the JAX kernel's smallest size, which the JAX package routes
    to its plain decoder) and at Z=20, there also against the TPU kernel in
    interpret mode, which packs several codewords per tile."""
    fields, backend = CHAIN_CASES[name]
    noise_var = np.float32(0.9 if fields is Z20 else 0.5)
    a, noise = _chain_inputs(fields, 12, noise_var, seed=len(name))
    rj = _jax_decode(fields, a, noise, noise_var, backend, 6)
    rt = _torch_decode(fields, a, noise, noise_var, 6)
    for field in ("a_hat", "tb_ok", "parity_ok", "iterations", "cb_crc_ok"):
        j, t = np.asarray(getattr(rj, field)), getattr(rt, field).numpy()
        assert j.dtype == t.dtype and j.shape == t.shape, field
        np.testing.assert_array_equal(j, t, err_msg=field)
    ok = rt.tb_ok.numpy()
    assert ok.any() and not ok.all()  # both outcomes
    assert len(set(rt.iterations.reshape(-1).tolist())) > 1
    pj = JParams(**fields)
    if backend == "pallas-interpret":
        assert j_pallas.supports(pj) and j_pallas._auto_pack(pj.Z_c) > 1
    if fields is Z5:
        assert not j_pallas.supports(pj) and t_cuda.supports(TParams(**fields))
