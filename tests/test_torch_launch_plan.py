"""The host side of a CUDA decode, on the CPU.

``decoder_cuda.decode`` runs per call, and at a sweep's 2,048 codewords of a
small code its host time is as long as the kernel's.  So what depends only
on the launch's shape (the kernel's limits, the block's shape, its shared
memory against the device's, the scratch) is worked out and checked against
the kernel library once per shape, by ``_launch_plan``.  Here a stand-in
library that answers by the sources' formulas shows that the plan agrees
with ``launch_shape`` and ``scratch_shape``, asks the library only once per
shape, and still refuses a block that the device cannot hold on every call.
"""
import contextlib

import pytest
import torch

from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.tools import small_z

RULES = ("min-sum", "offset-min-sum", "sum-product")
DEVICE = torch.device("cuda", 0)


class StandIn:
    """The layered and flooding libraries' host entry points, answered by
    the Python formulas that ``decode`` asserts they equal; counts calls."""

    def __init__(self, max_shared_bytes=t_cuda.MAX_BLOCK_SHARED_BYTES):
        self.calls = 0
        self.max_shared_bytes = max_shared_bytes

    def _count(self, value):
        self.calls += 1
        return value

    def __getattr__(self, name):
        answers = {"_max_degree": lambda: 32, "_max_z": lambda: 384,
                   "_max_shared_bytes": lambda: self.max_shared_bytes}
        for suffix, fn in answers.items():
            if name.endswith(suffix):
                return lambda: self._count(fn())
        raise AttributeError(name)

    def ldpc_layered_shared_bytes(self, rule, bf16, Z, nc, nr, E, P):
        return self._count(t_cuda.shared_bytes(
            "layered", Z, nc, nr, E, P, algorithm=RULES[rule],
            message_dtype="bfloat16" if bf16 else "float32"))

    def ldpc_layered_scratch_bytes(self, rule, bf16, Z, nc, nr, E, P):
        if rule == 2:
            return self._count(E * P * Z * 4)
        if t_cuda._warp_form(Z, P, RULES[rule]):
            return self._count(0)
        return self._count(nr * (2 if bf16 else 3) * P * Z * 4)

    def ldpc_flooding_shared_bytes(self, Z, nc, nr, E, P, layout, slots):
        params = next(p for p in _CODES.values() if p.Z_c == Z and p.num_cols == nc)
        return self._count(t_cuda.flooding_shared_bytes(params, layout, P))


_CODES = {f"z{Z}": small_z.table_params(Z) for Z in (2, 8, 20, 32, 96)}


@pytest.fixture(autouse=True)
def _no_cuda_context(monkeypatch):
    # the plan asks for the device's shared memory inside its context
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    t_cuda._launch_plan.cache_clear()
    yield
    t_cuda._launch_plan.cache_clear()


def _order(params):
    return tuple(range(params.num_rows - 1, -1, -1))


@pytest.mark.parametrize("algorithm", RULES)
@pytest.mark.parametrize("code", sorted(_CODES))
def test_plan_agrees_with_the_launch_shape(code, algorithm):
    params = _CODES[code]
    for message_dtype in (("float32",) if algorithm == "sum-product"
                          else ("float32", "bfloat16")):
        for n in (0, 256, 2048, 65536):
            for asked in (0, 1, 4):
                if asked and not t_cuda._fits("layered", params, asked, algorithm,
                                              message_dtype):
                    continue
                lib = StandIn()
                P, layout, spec, block = t_cuda._launch_plan(
                    params, _order(params), n, "layered", asked, 132, algorithm,
                    message_dtype, 0, lib, DEVICE)
                shape = t_cuda.launch_shape(params, n, "layered", asked, 132, algorithm,
                                            message_dtype)
                assert (P, layout, block) == (shape["codewords_per_block"],
                                              shape["layout"], (P,))
                assert spec == (t_cuda.scratch_shape(params, n, "layered", algorithm,
                                                     message_dtype, P) if n else None)


@pytest.mark.parametrize("code", sorted(_CODES))
def test_flooding_plan_agrees_with_the_launch_shape(code):
    params = _CODES[code]
    for n, threads in ((256, 0), (2048, 0), (2048, 128)):
        P, layout, spec, block = t_cuda._launch_plan(
            params, tuple(range(params.num_rows)), n, "flooding", 0, 132, "min-sum",
            "float32", threads, StandIn(), DEVICE)
        shape = t_cuda.launch_shape(params, n, "flooding", 0, 132)
        assert (P, layout, spec) == (shape["codewords_per_block"], shape["layout"],
                                     t_cuda.scratch_shape(params, n, "flooding", P=P))
        assert block == (P, layout, threads or shape["threads"],
                         t_cuda._block_slots(params, layout, P))


def test_plan_asks_the_library_once_per_shape():
    params = _CODES["z8"]
    lib = StandIn()
    args = (params, _order(params), 2048, "layered", 0, 132, "min-sum", "bfloat16", 0,
            lib, DEVICE)
    first = t_cuda._launch_plan(*args)
    calls = lib.calls
    assert calls > 0
    for _ in range(3):
        assert t_cuda._launch_plan(*args) == first
    assert lib.calls == calls
    # another batch is another shape
    t_cuda._launch_plan(params, _order(params), 4096, *args[3:])
    assert lib.calls > calls


def test_plan_refuses_a_block_the_device_cannot_hold_on_every_call():
    params = _CODES["z20"]
    lib = StandIn(max_shared_bytes=1024)
    for _ in range(2):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            t_cuda._launch_plan(params, _order(params), 2048, "layered", 0, 132,
                                "min-sum", "float32", 0, lib, DEVICE)
