"""The port's matrix encoder ('mxu'): its generator byte for byte against
the JAX package's, its parity bit for bit against the port's roll/XOR
encoder (every batch shape, the padded sizes), and one configuration
against the JAX ``encode_mxu``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import encoder as j_ops
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.models import encoder as t_enc
from ldpc_3gpp_tpu_torch.ops import encoder as t_ops
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams

torch.set_num_threads(1)

# single-code-block configurations by lifting size: Z = 2 (BG1 only), odd
# Z, Z not a multiple of 8, and a multiple of 8; two code blocks last
CONFIGS = [
    dict(BG=1, A=28, G=84, Q_m=2),  # Z=2
    dict(BG=2, A=2, G=6, Q_m=2),  # Z=3
    dict(BG=1, A=94, G=282, Q_m=2),  # Z=5
    dict(BG=2, A=26, G=78, Q_m=2),  # Z=7
    dict(BG=1, A=314, G=942, Q_m=2),  # Z=15
    dict(BG=2, A=74, G=222, Q_m=2),  # Z=15
    dict(BG=2, A=100, G=300, Q_m=2),  # Z=20
    dict(BG=1, A=1000, G=3000, Q_m=2),  # Z=48
    dict(BG=2, A=3842, G=11526, Q_m=2),  # Z=208, C=2
]


def _bits(p, shape, seed):
    """Random code-block bits (fillers zero) of leading shape ``shape``."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, shape + (p.K,)).astype(np.int8)
    c[..., p.K_prime:] = 0
    return torch.from_numpy(c)


@pytest.mark.parametrize("fields", CONFIGS)
def test_parity_generator_equals_jax(fields):
    tp, jp = TParams(**fields), JParams(**fields)
    g_t, g_j = t_ops._parity_generator(tp), j_ops._parity_generator(jp)
    assert g_t.dtype == g_j.dtype == np.float32 and g_t.shape == g_j.shape
    assert g_t.tobytes() == g_j.tobytes()


@pytest.mark.parametrize("fields", CONFIGS)
def test_mxu_equals_rolls(fields):
    """Every leading shape, one codeword up to the row padding (fewer than
    17 rows) and beyond it."""
    p = TParams(**fields)
    gp = t_ops.parity_generator_device(p, torch.device("cpu"))
    P = (p.num_cols - p.num_sys_cols) * p.Z_c
    assert gp.dtype == torch.int8
    assert gp.shape == (-(-p.K // 8) * 8, -(-P // 8) * 8)
    for i, shape in enumerate([(), (1,), (3,), (2, 3, p.C), (40,)]):
        c = _bits(p, shape, i)
        want = t_ops.encode(p, c)
        got = t_ops.encode_mxu(p, c)
        assert got.dtype == torch.uint8 and torch.equal(got, want), shape
        assert torch.equal(t_ops.encode_mxu(p, c, gp), want)


def test_mxu_equals_jax_encode_mxu():
    fields = dict(BG=2, A=100, G=300, Q_m=2)
    tp, jp = TParams(**fields), JParams(**fields)
    c = _bits(tp, (5,), 3)
    want = np.asarray(j_ops.encode_mxu(jp, jnp.asarray(c.numpy())))
    got = t_ops.encode_mxu(tp, c).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fields,modulation", [
    (dict(BG=2, A=100, G=300, Q_m=2, rv_id=2), "QPSK"),
    (dict(BG=2, A=3842, G=11528, Q_m=4, rv_id=1), "16QAM"),
    (dict(BG=1, A=20004, G=60012, Q_m=2, CBGTI=(1,)), "QPSK"),
])
def test_transport_block_mxu_equals_rolls(fields, modulation):
    p = TParams(**fields)
    a = torch.from_numpy(
        np.random.default_rng(1).integers(0, 2, (3, p.A)).astype(np.int8))
    assert torch.equal(
        t_enc.encode_transport_block(p, a, backend="mxu"),
        t_enc.encode_transport_block(p, a, backend="rolls"))
    assert torch.equal(
        t_enc.encode_to_symbols(p, a, modulation, backend="mxu"),
        t_enc.encode_to_symbols(p, a, modulation))
    with pytest.raises(KeyError):
        t_enc.encode_transport_block(p, a, backend="unknown")
