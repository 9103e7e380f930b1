"""The port's segment-op flooding decoder (backend 'reference') against the
JAX package's ``ops/decoder.py::decode`` at tolerance 0 (bits, parity flags,
iteration counts) on the same numpy-made LLRs, and the transport-block
decoder with ``backend='reference'`` against ``'fast'``."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder as j_ref
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.models import decoder as t_dec
from ldpc_3gpp_tpu_torch.ops import decoder as t_ref
from ldpc_3gpp_tpu_torch.ops import encoder as t_ops
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams

torch.set_num_threads(1)

FIELDS = dict(BG=2, A=100, G=300, Q_m=2)  # Z=20
ITERATIONS = 10


def _noisy_codeword_llrs(p, shape, seed):
    """LLRs of random codewords at noise levels from 1.0 to 1.8 standard
    deviations over codewords, where they stop after different numbers of
    iterations and some never do."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, shape + (p.K,)).astype(np.int8)
    c[..., p.K_prime:] = 0
    cw = t_ops.encode(p, torch.from_numpy(c)).numpy()
    sigma = np.linspace(1.0, 1.8, int(np.prod(shape))).reshape(shape + (1,))
    llr = (1.0 - 2.0 * cw) * 1.2 + rng.standard_normal(cw.shape) * sigma
    llr[..., : 2 * p.Z_c] = 0.0  # punctured
    return llr.astype(np.float32)


@pytest.mark.parametrize("algorithm,early_termination", [
    ("min-sum", True),
    ("offset-min-sum", True),
    ("sum-product", True),
    ("min-sum", False),
    ("sum-product", False),
])
def test_reference_equals_jax_oracle(algorithm, early_termination):
    tp, jp = TParams(**FIELDS), JParams(**FIELDS)
    llr = _noisy_codeword_llrs(tp, (2, 6), 1)
    kw = dict(iterations=ITERATIONS, algorithm=algorithm,
              early_termination=early_termination)
    want = j_ref.decode(jp, jnp.asarray(llr), **kw)
    got = t_ref.decode(tp, torch.from_numpy(llr), **kw)
    assert (got.bits.dtype, got.parity_ok.dtype, got.iterations.dtype) == (
        torch.int8, torch.bool, torch.int32)
    for name in ("bits", "parity_ok", "iterations"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    if early_termination:  # the inputs exercise the masked termination
        its = got.iterations.flatten().tolist()
        assert len(set(its)) > 1 and not got.parity_ok.all(), its


def test_reference_equals_plain_flooding_decoder():
    """Odd Z at base graph 1, all three rules, early termination: the
    segment-op oracle and the plain row-scan decoder agree bit for bit."""
    from ldpc_3gpp_tpu_torch.ops import decoder_fast

    p = TParams(BG=1, A=300, G=900, Q_m=2)  # Z=15
    llr = torch.from_numpy(_noisy_codeword_llrs(p, (8,), 2))
    for algorithm in ("min-sum", "offset-min-sum", "sum-product"):
        kw = dict(iterations=6, algorithm=algorithm)
        got, want = t_ref.decode(p, llr, **kw), decoder_fast.decode(p, llr, **kw)
        for name in ("bits", "parity_ok", "iterations"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (algorithm, name)


def test_reference_sums_are_gathers_not_scatters():
    """The reference's sums take a fixed order on every device: no
    scatter-add, whose order on CUDA follows its atomics."""
    src = inspect.getsource(t_ref)
    for name in ("index_add", "scatter_add", "scatter_reduce", "segment_reduce"):
        assert name not in src, name


def test_transport_block_reference_equals_fast():
    p = TParams(BG=2, A=1522, G=2284, Q_m=2)
    rng = np.random.default_rng(5)
    g = rng.integers(0, 2, (4, p.G))
    llr = torch.from_numpy(
        ((1.0 - 2.0 * g) * 1.5 + rng.standard_normal(g.shape)).astype(np.float32))
    for algorithm in ("min-sum", "offset-min-sum"):
        kw = dict(iterations=6, algorithm=algorithm)
        ref = t_dec.decode_transport_block(p, llr, backend="reference", **kw)
        fast = t_dec.decode_transport_block(p, llr, backend="fast", **kw)
        for name in ("a_hat", "tb_ok", "cb_crc_ok", "parity_ok", "iterations"):
            assert torch.equal(getattr(ref, name), getattr(fast, name)), name
        for x, y in zip(ref.state, fast.state):
            assert torch.equal(x, y)
        d = t_dec.split_rate_matched(p, llr)
        ref_d = t_dec.decode_transport_block_d(p, d, ref.state, backend="reference", **kw)
        fast_d = t_dec.decode_transport_block_d(p, d, fast.state, backend="fast", **kw)
        assert torch.equal(ref_d.a_hat, fast_d.a_hat)
        assert torch.equal(ref_d.iterations, fast_d.iterations)


def test_reference_backend_rejects_kernel_knobs():
    p = TParams(**FIELDS)
    d = torch.zeros(2, p.C, p.N)
    with pytest.raises(ValueError, match="schedule"):
        t_dec.decode_transport_block_d(p, d, backend="reference", schedule="layered")
    with pytest.raises(ValueError, match="alpha_schedule"):
        t_dec.decode_transport_block_d(
            p, d, backend="reference", algorithm="min-sum", alpha_schedule=(0.6, 2))
    with pytest.raises(ValueError, match="f32-only"):
        t_dec.decode_transport_block_d(
            p, d, backend="reference", algorithm="min-sum", message_dtype="bfloat16")
