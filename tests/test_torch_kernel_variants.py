"""What only the decoder kernels have, with no plain JAX counterpart: the
flooding schedule with 'd' input and 'sys' output, flooding min-sum with
``alpha_schedule``, and bfloat16 messages in both schedules.

``decoder_cuda.decode`` on CPU tensors (the kernels' plain version) is held
against the TPU kernel run in interpret mode on the same numpy LLRs: bits,
``parity_ok`` and ``iterations`` equal, tolerance 0.  One case each, 3
codewords, 4 iterations; the interpreted kernel's compile is the cost.
"""
from functools import partial

import jax
import jax.numpy as jnp
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder_pallas as j_pallas
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from test_torch_decoder import Z20, _assert_result_equal, _mixed_llrs
from test_torch_flooding import _raw_d

torch.set_num_threads(1)

KERNEL_CASES = {
    "flooding_sum_product_d_sys": (
        "d", dict(schedule="flooding", algorithm="sum-product",
                  channel_format="d", output_format="sys")),
    "flooding_min_sum_alpha_schedule": (
        "cw", dict(schedule="flooding", algorithm="min-sum", alpha=0.8,
                   alpha_schedule=(0.65, 2))),
    "layered_bfloat16": ("cw", dict(schedule="layered", message_dtype="bfloat16")),
    "flooding_bfloat16_offset": (
        "d", dict(schedule="flooding", algorithm="offset-min-sum",
                  message_dtype="bfloat16", channel_format="d",
                  output_format="sys")),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_decoder_cuda_on_cpu_matches_jax_kernel_interpreted(name):
    """What only the kernels have, against the TPU kernel in interpret mode
    (3 codewords, 4 iterations)."""
    fmt, kw = KERNEL_CASES[name]
    pj, pt = JParams(**Z20), TParams(**Z20)
    full = _mixed_llrs(pt, seed=31)[[0, 3, 7]]
    llr = _raw_d(pt, full) if fmt == "d" else full
    rj = jax.jit(partial(j_pallas.decode, pj, interpret=True, iterations=4, **kw))(
        jnp.asarray(llr))
    rt = t_cuda.decode(pt, torch.from_numpy(llr), iterations=4, **kw)
    _assert_result_equal(rj, rt)
    assert (rt.iterations.numpy() > 1).all()  # stored messages were read back
    assert rt.parity_ok.any() and not rt.parity_ok.all()
