"""The op-rate microbenchmark's plain chains (the plain version of kernel
K2) against a numpy float32 evaluation of the same recipe, class by class,
bit for bit; on the CPU the wrapper runs the plain version."""
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu_torch.tools import op_rates

torch.set_num_threads(1)
f32 = np.float32
LOOPS = 2


def _numpy_chains(op, x, loops):
    c = np.arange(op_rates.CHAINS, dtype=f32)
    v = (x[:, None] + c).astype(f32)
    masks = op_rates.MASKS
    for _ in range(loops):
        for k in range(op_rates.INNER):
            if op == "addmul":
                v = (v * f32(1.000001) + f32(0.5)) if k % 2 else v * f32(0.999999)
            elif op == "minmax":
                v = np.minimum(v, f32(3.0) + c) if k % 2 else np.maximum(v, f32(-3.0) - c)
            elif op == "select":
                v = np.where(v > c, v - f32(1e-7), v + f32(1e-7))
            else:
                b = v.view(np.int32)
                b = b ^ masks[(k >> 1) & 3] if k % 2 else b & masks[4 + ((k >> 1) & 3)]
                v = b.view(f32)
            assert v.dtype == f32
    if op == "bitops":
        return np.bitwise_xor.reduce(v.view(np.int32), axis=-1)
    t = v[:, 0]
    for i in range(1, op_rates.CHAINS):
        t = t + v[:, i]
    return t.view(np.int32)


@pytest.mark.parametrize("op", op_rates.ALU_CLASSES)
def test_arithmetic_chains_match_numpy(op):
    x = op_rates.make_input(op, 3, 32, 32, seed=4)
    got = op_rates.run(op, torch.from_numpy(x), LOOPS, threads=32)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), _numpy_chains(op, x, LOOPS))
    assert len(np.unique(got.numpy().view(np.int32))) > 10  # not a constant


def test_rotation_matches_numpy():
    x = op_rates.make_input("rotate", 2, 32, 20, seed=5)
    want = x
    for _ in range(LOOPS):
        for k in range(op_rates.INNER):
            want = np.roll(want, -((1 + k % 5) % 20), axis=-1)
    got = op_rates.run("rotate", torch.from_numpy(x), LOOPS, threads=32)
    np.testing.assert_array_equal(got.numpy(), want)
    total = LOOPS * sum((1 + k % 5) for k in range(op_rates.INNER))
    np.testing.assert_array_equal(got.numpy(), np.roll(x, -(total % 20), axis=-1))
    tiny = op_rates.make_input("rotate", 1, 32, 2, seed=6)  # shifts wrap at Z = 2
    assert op_rates.plain("rotate", torch.from_numpy(tiny), 1).shape == tiny.shape


def test_scratch_stream_matches_numpy():
    x = op_rates.make_input("scratch", 3, 32, 20, seed=7)
    E, sweeps = 16, 3
    want = (x[:, None, :] + np.arange(E, dtype=f32)[None, :, None]).astype(f32)
    for _ in range(sweeps - 1):
        want = want + f32(1.0)
    got = op_rates.run("scratch", torch.from_numpy(x), sweeps, threads=32, E=E)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        op_rates.run("scratch", torch.from_numpy(x), 0, threads=32, E=E)
    with pytest.raises(ValueError):
        op_rates.run("nonsense", torch.from_numpy(x), 1, threads=32)


def test_work_counts_and_shapes():
    w = op_rates.work("select", 4, 32, 32, 0, 2)
    assert w["operations"] == 4 * 32 * 16 * 64 * 2 * 2 and w["bytes"] == 0
    w = op_rates.work("rotate", 4, 32, 20, 0, 1)
    assert w["operations"] == 4 * 20 * 16 * 64 and w["bytes"] == 8 * w["operations"]
    assert op_rates.work("scratch", 2, 32, 20, 16, 3)["bytes"] == 2 * 16 * 20 * 4 * 5
    assert op_rates.scratch_edges(316) == 312 and op_rates.scratch_edges(197) == 192
    assert op_rates.smem_for_blocks_per_sm(1) == 232_448  # what one block may ask for
    assert 2 * (op_rates.smem_for_blocks_per_sm(2) + 1024) <= op_rates.SM_SHARED_BYTES
    assert 3 * (op_rates.smem_for_blocks_per_sm(2) + 1024) > op_rates.SM_SHARED_BYTES
    assert op_rates.input_shape("rotate", 3, 32, 20) == (3, 16, 20)
    assert sum(op_rates.OPS_PER_STEP.values()) == 6.5
    assert op_rates.main() == 1 or torch.cuda.is_available()  # no GPU: refuses
