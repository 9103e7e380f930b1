"""Op-rate microbenchmark behind the BP kernels' roofline (kernel K2).

The counterpart of the JAX package's ``tools/vpu_ceiling.py``: what a kernel
sustains on an NVIDIA GPU, in the decoder's block shape and built with the
decoder's flags, for six classes of the decoder's work (``CLASSES``): the five
of the TPU tool (multiply/add, min/max, compare-select, integer bit
operations, rotation; 16 chains of 64 steps, looped) and the scratch stream
(the decoder's global message traffic).  The kernels are in
``csrc/op_rates.cu``; ``plain`` is their plain PyTorch version, equal bit for
bit at any loop count.

    python3 -m ldpc_3gpp_tpu_torch.tools.op_rates

prints one JSON line per class and block shape (operations/s, bytes/s where
they apply) with the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

import numpy as np
import torch

from .. import kernels_build

KERNEL_NAME = "op_rates"
CLASSES = ("addmul", "minmax", "select", "bitops", "rotate", "scratch")
ALU_CLASSES = CLASSES[:4]
CHAINS = 16  # independent dependency chains per thread
INNER = 64  # steps per chain and loop
SCRATCH_GROUP = 8  # edges in flight per thread in the scratch stream
# Elementwise operations per step: an odd multiply/add step is a multiply and
# an add (the build does not fuse them), an even one a multiply; a select is a
# compare and a select (its add or subtract is not counted, as in the TPU
# tool); a rotation is one shared-memory read and one write.
OPS_PER_STEP = {"addmul": 1.5, "minmax": 1.0, "select": 2.0, "bitops": 1.0,
                "rotate": 1.0}
# The bit-operation class's run-time operands: four xor words, four and masks.
MASKS = np.array(
    [0x00000001, 0x80000002, 0x00400004, 0x80000008,
     0x7FFFFFFF, 0xFFFFFFFD, 0xFFBFFFFF, 0xFFFFFFF7], dtype=np.uint32
).view(np.int32)

# Shared memory of one SM and what the hardware keeps back per block: a block
# that asks for ``smem_for_blocks_per_sm(b)`` bytes shares its SM with b - 1
# others.
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024

# Argument types of ``op_rates_run``: op, x, y, masks, blocks, threads, Z, E,
# loops, smem_bytes, stream.
RUN_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
)

# Launches of the kernel made by ``run`` in this process.
LAUNCHES = {KERNEL_NAME: 0}


def reset_launches() -> None:
    LAUNCHES[KERNEL_NAME] = 0


def smem_for_blocks_per_sm(blocks_per_sm: int) -> int:
    """Dynamic shared memory to ask for so that exactly ``blocks_per_sm``
    blocks fit one SM (as far as shared memory decides)."""
    return SM_SHARED_BYTES // blocks_per_sm - BLOCK_RESERVED_BYTES


def input_shape(op: str, blocks: int, threads: int, Z: int):
    """Shape of the input tile of class ``op``."""
    if op in ALU_CLASSES:
        return (blocks * threads,)
    return (blocks, CHAINS, Z) if op == "rotate" else (blocks, Z)


def make_input(op: str, blocks: int, threads: int, Z: int, seed: int = 0) -> np.ndarray:
    """Float32 input tile from a numpy seed, values in [-4, 4)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-4.0, 4.0, input_shape(op, blocks, threads, Z)).astype(np.float32)


def scratch_edges(E: int) -> int:
    """Edges the scratch stream runs for a code of ``E`` edges: the multiple
    of ``SCRATCH_GROUP`` below."""
    return E // SCRATCH_GROUP * SCRATCH_GROUP


def plain(op: str, x: torch.Tensor, loops: int, E: int = 0) -> torch.Tensor:
    """Plain PyTorch version of class ``op`` on the device of ``x``.

    Arithmetic classes: (n,) -> (n,), the 16 chains summed (bit operations:
    xor-ed, as int32 bits in a float32 tensor).  'rotate': (blocks, 16, Z) ->
    the same, every step a roll.  'scratch': (blocks, Z) -> the
    (blocks, E, Z) scratch after ``loops`` sweeps.
    """
    f32 = dict(dtype=torch.float32, device=x.device)
    if op == "rotate":
        Z = x.shape[-1]
        for _ in range(loops):
            for k in range(INNER):
                x = torch.roll(x, -((1 + k % 5) % Z), dims=-1)
        return x
    if op == "scratch":
        e = torch.arange(E, **f32)
        m = x.unsqueeze(1) + e[None, :, None]
        one = torch.tensor(1.0, **f32)
        for _ in range(loops - 1):
            m = m + one
        return m
    c = torch.arange(CHAINS, **f32)
    v = x.unsqueeze(-1) + c  # (n, CHAINS)
    const = lambda value: torch.tensor(value, **f32)
    masks = torch.from_numpy(MASKS).to(x.device)
    for _ in range(loops):
        for k in range(INNER):
            if op == "addmul":
                v = v * const(1.000001) + const(0.5) if k % 2 else v * const(0.999999)
            elif op == "minmax":
                v = (torch.minimum(v, const(3.0) + c) if k % 2
                     else torch.maximum(v, -const(3.0) - c))
            elif op == "select":
                v = torch.where(v > c, v - const(1e-7), v + const(1e-7))
            elif op == "bitops":
                b = v.view(torch.int32)
                b = b ^ masks[(k >> 1) & 3] if k % 2 else b & masks[4 + ((k >> 1) & 3)]
                v = b.view(torch.float32)
            else:
                raise ValueError(f"unknown class {op!r}")
    if op == "bitops":
        b = v.view(torch.int32)
        t = b[..., 0]
        for i in range(1, CHAINS):
            t = t ^ b[..., i]
        return t.view(torch.float32)
    t = v[..., 0]
    for i in range(1, CHAINS):
        t = t + v[..., i]
    return t


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels_build.load(KERNEL_NAME)
    lib.op_rates_run.argtypes = RUN_ARGTYPES
    lib.op_rates_run.restype = ctypes.c_int
    for fn in ("chains", "inner", "scratch_group"):
        f = getattr(lib, "op_rates_" + fn)
        f.argtypes = []
        f.restype = ctypes.c_int
    assert (lib.op_rates_chains(), lib.op_rates_inner(),
            lib.op_rates_scratch_group()) == (CHAINS, INNER, SCRATCH_GROUP)
    return lib


def run(op: str, x: torch.Tensor, loops: int, threads: int, E: int = 0,
        blocks_per_sm: int = 1) -> torch.Tensor:
    """Class ``op`` on a CUDA tensor: launches the kernel (or raises) with
    ``threads`` threads per block and the shared memory that lets
    ``blocks_per_sm`` blocks share an SM.  Shapes as ``plain``; a CPU tensor
    runs ``plain``."""
    if op not in CLASSES:
        raise ValueError(f"unknown class {op!r}")
    if op == "scratch" and loops < 1:
        raise ValueError("the scratch stream needs at least one sweep")
    if not x.is_cuda:
        return plain(op, x, loops, E)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("op_rates.run needs a contiguous float32 tensor")
    if op in ALU_CLASSES:
        if x.dim() != 1 or x.numel() % threads:
            raise ValueError("arithmetic classes take blocks*threads values")
        blocks, Z = x.numel() // threads, threads
        y = torch.empty_like(x)
    else:
        blocks, Z = x.shape[0], x.shape[-1]
        if Z > threads or (op == "scratch" and (E < 1 or E % SCRATCH_GROUP)):
            raise ValueError(f"bad shape for class {op!r}: Z={Z}, E={E}")
        y = (torch.empty_like(x) if op == "rotate"
             else torch.empty((blocks, E, Z), dtype=torch.float32, device=x.device))
    smem = smem_for_blocks_per_sm(blocks_per_sm)
    if op == "rotate" and smem < 2 * CHAINS * Z * 4:
        raise ValueError("two rotation tiles do not fit the shared memory asked for")
    masks = torch.from_numpy(MASKS).to(x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.op_rates_run(
            CLASSES.index(op), x.data_ptr(), y.data_ptr(), masks.data_ptr(),
            blocks, threads, Z, E, int(loops), smem,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"op_rates kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL_NAME] += 1
    return y


def work(op: str, blocks: int, threads: int, Z: int, E: int, loops: int) -> dict:
    """Operations and bytes of one launch: elementwise operations for the
    arithmetic classes, rotations and shared-memory bytes for 'rotate',
    global bytes for 'scratch' (one write per sweep, one read per sweep after
    the first)."""
    if op == "scratch":
        return dict(operations=0.0, bytes=float(blocks * E * Z * 4 * max(2 * loops - 1, 0)))
    lanes = blocks * (Z if op == "rotate" else threads)
    ops = lanes * CHAINS * INNER * loops * OPS_PER_STEP[op]
    return dict(operations=ops, bytes=ops * 8.0 if op == "rotate" else 0.0)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(op: str, blocks: int, threads: int, Z: int, E: int, loops: int,
            device, blocks_per_sm: int = 1) -> int:
    """Kernel against plain version on the same seeded input: the number of
    differing values (bit patterns).  Tolerance 0."""
    x = torch.from_numpy(make_input(op, blocks, threads, Z)).to(device)
    got = run(op, x, loops, threads, E, blocks_per_sm)
    torch.cuda.synchronize()
    want = plain(op, x, loops, E)
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def measure(op: str, threads: int, Z: int, E: int, blocks_per_sm: int, loops: int,
            device, reps: int = 3) -> dict:
    """Sustained rate of class ``op`` with ``blocks_per_sm`` blocks of
    ``threads`` threads on every SM, timed by CUDA events over ``reps``
    launches after a warm-up."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * blocks_per_sm
    E = scratch_edges(E)
    x = torch.from_numpy(make_input(op, blocks, threads, Z)).to(device)
    seconds = time_ms(lambda: run(op, x, loops, threads, E, blocks_per_sm), reps) / 1e3
    w = work(op, blocks, threads, Z, E, loops)
    return {
        "class": op, "threads": threads, "Z": Z, "E": E, "blocks": blocks,
        "blocks_per_sm": blocks_per_sm, "loops": loops, "ms": seconds * 1e3,
        "operations_per_s": w["operations"] / seconds if w["operations"] else None,
        "bytes_per_s": w["bytes"] / seconds if w["bytes"] else None,
    }


# Loop counts that keep a launch in the milliseconds at the full block shape.
DEFAULT_LOOPS = {"addmul": 1024, "minmax": 1024, "select": 1024, "bitops": 1024,
                 "rotate": 128, "scratch": 8}


def rates(threads: int, Z: int, E: int, blocks_per_sm: int, device) -> dict:
    """{class: measurement} for one block shape."""
    return {op: measure(op, threads, Z, E, blocks_per_sm, DEFAULT_LOOPS[op], device)
            for op in CLASSES}


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("op_rates: no CUDA device; this tool measures a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    for op in CLASSES:
        differing = compare(op, 6, 96, 52, 40, 2, device)
        if differing:
            raise AssertionError(f"class {op}: {differing} values differ from the plain version")
    # the decoder's block shapes: Z = 384 (BG1, E = 316), and the small-Z rows
    for threads, Z in ((384, 384), (128, 128), (32, 20)):
        for blocks_per_sm in (1, 2):
            for rec in rates(threads, Z, 316, blocks_per_sm, device).values():
                print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
