"""The one-codeword flooding kernel's plans and rules, on the wrapper's side
(the kernel itself only runs on the card): the column plan, the shared-memory
formula and the layout rule against the CUDA source, and the block size."""
import os
import re

import numpy as np
import pytest

from ldpc_3gpp_tpu_torch import kernels_build
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.spec.tables import ALL_LIFTING_SIZES
from ldpc_3gpp_tpu_torch.tools import small_z

P2 = dict(BG=2, A=3842, G=11526, Q_m=2)  # Z=208, the default decoder's step
BG1_Z384 = dict(BG=1, A=8424, G=25272, Q_m=2)
BG2_Z52 = dict(BG=2, A=400, G=1200, Q_m=2)


def _source():
    with open(os.path.join(kernels_build.CSRC_DIR, "ldpc_flooding.cu")) as f:
        return f.read()


def _c_shared_bytes():
    """FLOODING_SHARED_BYTES of the CUDA source as a Python function: the
    macro's body with its casts dropped (the rest is valid Python)."""
    m = re.search(r"#define FLOODING_SHARED_BYTES\((.*?)\)(.*?)\n\n", _source(), re.S)
    names = [a.strip() for a in m.group(1).split(",")]
    body = m.group(2).replace("\\\n", " ").replace("(size_t)", "")
    return lambda *args: eval(  # noqa: S307 - the repository's own source
        body, {"align16": lambda n: -(-n // 16) * 16}, dict(zip(names, args)))


@pytest.mark.parametrize("fields", [P2, BG1_Z384, BG2_Z52], ids=["bg2_z208", "bg1_z384", "bg2_z52"])
def test_column_plan_lists_each_column_in_row_order(fields):
    """Per column its edges in ascending row order, as [slot*Z, shift] with
    slot the edge's position in the row plan; the first entry of a column is
    the edge ``_graph_plan`` marks first."""
    pt = TParams(**fields)
    Z = pt.Z_c
    edges, row_start, _ = t_cuda._graph_plan(pt, tuple(range(pt.num_rows)))
    col_edges, col_start = t_cuda._column_plan(pt)
    assert col_edges.dtype == np.int32 and col_edges.shape == (len(edges), 2)
    assert col_start[0] == 0 and col_start[-1] == len(edges)
    assert len(col_start) == pt.num_cols + 1
    row_of = np.repeat(np.arange(pt.num_rows), np.diff(row_start))
    slots = []
    for c in range(pt.num_cols):
        seg = col_edges[col_start[c]:col_start[c + 1]]
        assert len(seg) >= 1
        slot = seg[:, 0] // Z
        assert (seg[:, 0] % Z == 0).all()
        assert (edges[slot, 0] == c * Z).all()  # every entry is of column c
        np.testing.assert_array_equal(seg[:, 1], edges[slot, 1])  # its shift
        assert (np.diff(row_of[slot]) > 0).all()  # ascending rows
        assert edges[slot[0], 3] == 1 and (edges[slot[1:], 3] == 0).all()
        slots.extend(slot.tolist())
    assert sorted(slots) == list(range(len(edges)))  # every edge once


def test_shared_bytes_and_layout_rule_follow_the_cuda_source():
    """The wrapper's one-block formula equals the source's
    FLOODING_SHARED_BYTES at every lifting size of both base graphs, and one
    block holds a codeword exactly up to BG2 Z=224 and BG1 Z=144."""
    c_bytes = _c_shared_bytes()
    src = _source()
    assert f"#define FLOODING_MAX_THREADS {t_cuda.FLOODING_MAX_THREADS}" in src
    assert "return threads >= 32 && threads <= FLOODING_MAX_THREADS" in src
    seen = set()
    for fields in (BG1_Z384, P2):
        pt = TParams(**fields)
        nc, nr, E = pt.num_cols, pt.num_rows, len(pt.edges[0])
        for Z in ALL_LIFTING_SIZES:
            assert t_cuda.shared_bytes("flooding", Z, nc, nr, E) == c_bytes(Z, nc, nr, E)
            seen.add((pt.BG, Z, c_bytes(Z, nc, nr, E) <= t_cuda.MAX_BLOCK_SHARED_BYTES))
    assert {(2, 224, True), (2, 240, False), (1, 144, True), (1, 160, False)} <= seen
    assert all(fits == (Z <= {1: 144, 2: 224}[bg]) for bg, Z, fits in seen)
    # the rule on a code's parameters is the same rule
    for bg, Z in ((2, 224), (2, 240), (1, 144), (1, 160)):
        pt = small_z.params_for_z(bg, Z)
        assert t_cuda.flooding_on_chip(pt) == ((bg, Z, True) in seen)
        layout = t_cuda.flooding_layout(pt)
        assert (layout == t_cuda.LAYOUT_ON_CHIP) == t_cuda.flooding_on_chip(pt)
        assert t_cuda.flooding_shared_bytes(pt, layout) <= t_cuda.MAX_BLOCK_SHARED_BYTES


def test_cluster_split_and_its_shared_bytes():
    """A cluster's blocks own contiguous rows (about E/size edges each) and
    columns that cover the code once; the wrapper's bytes equal the source's
    FLOODING_CLUSTER_SHARED_BYTES, and the rule takes the fewest blocks that
    fit where one block does not hold the messages."""
    m = re.search(r"#define FLOODING_CLUSTER_SHARED_BYTES\((.*?)\)(.*?)\n(?:#|\n)",
                  _source(), re.S)
    names = [a.strip() for a in m.group(1).split(",")]
    body = m.group(2).replace("\\\n", " ").replace("(size_t)", "")
    align16 = {"align16": lambda n: -(-n // 16) * 16}
    assert f"#define MAX_CLUSTER {t_cuda.MAX_CLUSTER}" in _source()
    for fields in (P2, BG1_Z384, BG2_Z52):
        pt = TParams(**fields)
        Z, nc, nr, E = pt.Z_c, pt.num_cols, pt.num_rows, len(pt.edges[0])
        _, row_start, _ = t_cuda._graph_plan(pt, tuple(range(nr)))
        for size in range(2, t_cuda.MAX_CLUSTER + 1):
            splits, cols_max, edges_max = t_cuda._cluster_split(pt, size)
            row_lo, col_lo = splits[:size + 1], splits[size + 1:]
            assert splits.dtype == np.int32 and len(splits) == 2 * (size + 1)
            assert row_lo[0] == 0 and row_lo[-1] == nr and (np.diff(row_lo) > 0).all()
            assert col_lo[0] == 0 and col_lo[-1] == nc and (np.diff(col_lo) > 0).all()
            edges = np.diff(row_start[row_lo])
            assert edges_max == edges.max() and cols_max == np.diff(col_lo).max()
            assert edges.max() - edges.min() <= 2 * 19  # within two of the densest rows
            want = eval(body, align16, dict(zip(names, (Z, nc, nr, E, cols_max, edges_max))))  # noqa: S307
            assert t_cuda.flooding_shared_bytes(pt, size) == want
        layout = t_cuda.flooding_layout(pt)
        if t_cuda.flooding_on_chip(pt):
            assert layout == t_cuda.LAYOUT_ON_CHIP
        else:
            assert layout >= 2
            assert t_cuda.flooding_shared_bytes(pt, layout) <= t_cuda.MAX_BLOCK_SHARED_BYTES
            assert t_cuda.flooding_shared_bytes(pt, layout - 1) > t_cuda.MAX_BLOCK_SHARED_BYTES


def test_layout_rule_at_the_paths_shapes():
    """One block per codeword at P2's shape (BG2 Z=208) and at BG1 Z=144; a
    cluster at BG1 Z=384 (snr_vs_a's largest code and the flagship's)."""
    assert t_cuda.flooding_on_chip(TParams(**P2))
    assert t_cuda.flooding_on_chip(small_z.params_for_z(1, 144))
    assert not t_cuda.flooding_on_chip(TParams(**BG1_Z384))
    shape = t_cuda.launch_shape(TParams(**P2), 2048, "flooding")
    assert shape == dict(codewords_per_block=1, threads=1024, layout=t_cuda.LAYOUT_ON_CHIP)
    shape = t_cuda.launch_shape(TParams(**BG1_Z384), 256, "flooding")
    assert shape == dict(codewords_per_block=1, threads=1024, layout=3)
    # the layered and packed kernels keep one thread per lane
    assert t_cuda.launch_shape(TParams(**P2), 2048, "layered") == dict(
        codewords_per_block=1, threads=224, layout=t_cuda.LAYOUT_SCRATCH)
    # the packed flooding kernel: P codewords' messages on chip, two blocks
    # of 512 threads per SM at config #1's launch
    z20 = small_z.table_params(20)
    assert t_cuda.launch_shape(z20, 2048, "flooding", 4) == dict(
        codewords_per_block=4, threads=512, layout=t_cuda.LAYOUT_ON_CHIP)


def test_block_size_rule():
    """Whole warps within the kernel's limit, no more threads than column
    items, and no more blocks per SM than its shared memory holds or than
    half the launch gives each SM."""
    for Z in (2, 5, 8, 13, 20, 36, 48, 96, 144, 208, 224, 240, 320, 384):
        pt = small_z.table_params(Z)
        items = pt.num_cols * Z
        for n in (1, 256, 2048, 16384):
            T = t_cuda.flooding_threads(pt, n)
            assert T % 32 == 0 and 32 <= T <= t_cuda.FLOODING_MAX_THREADS
            assert T <= -(-items // 32) * 32
            layout = t_cuda.flooding_layout(pt)
            smem = t_cuda.flooding_shared_bytes(pt, layout)
            blocks = max(1, min(
                t_cuda.SM_SHARED_BYTES // (smem + t_cuda.BLOCK_RESERVED_BYTES),
                -(-n * max(layout, 1) // (2 * 132))))
            # the widest whole-warp block of which `blocks` share an SM
            assert T * blocks <= t_cuda.FLOODING_MAX_THREADS or T == 32
            if 32 < T < -(-items // 32) * 32:
                assert (T + 32) * blocks > t_cuda.FLOODING_MAX_THREADS
    # the measured cases (PERF.md): Z=20, 2,048 codewords -> 128 threads;
    # snr_vs_a's 256-codeword calls -> the whole SM
    assert t_cuda.flooding_threads(small_z.table_params(20), 2048) == 128
    for A in (1000, 8000):
        pt = TParams(BG=1, A=A, G=3 * A, Q_m=2)
        assert t_cuda.flooding_threads(pt, 256) == 1024


def test_forced_shape_of_the_measuring_tool():
    """``tools.flooding_shapes`` times the alternatives to the block-size
    rule through ``decode``'s internal, keyword-only ``_threads`` (the rule's
    module functions stay as they are); every case is a flooding launch of a
    code of the port whose block sizes the kernel accepts, and on a CPU
    tensor the argument changes nothing."""
    import inspect

    import torch

    from ldpc_3gpp_tpu_torch.tools import flooding_shapes

    arg = inspect.signature(t_cuda.decode).parameters["_threads"]
    assert arg.kind is inspect.Parameter.KEYWORD_ONLY and arg.default == 0
    assert not hasattr(flooding_shapes, "forced_shape")
    for case, fields, _, n, kw, threads in flooding_shapes.CASES:
        pt = TParams(**fields)
        assert kw["schedule"] == "flooding" and n in (256, 2048), case
        assert t_cuda.launch_shape(pt, n, "flooding")["codewords_per_block"] == 1
        assert all(T % 32 == 0 and 32 <= T <= t_cuda.FLOODING_MAX_THREADS for T in threads)
    assert flooding_shapes.SEEDS and len(set(flooding_shapes.SEEDS)) == len(flooding_shapes.SEEDS)
    pt = small_z.params_for_z(2, 8)
    llr = torch.from_numpy(
        np.random.default_rng(5).normal(1.0, 1.5, (3, pt.num_cols * 8)).astype(np.float32))
    kw = dict(schedule="flooding", iterations=3, algorithm="min-sum")
    a = t_cuda.decode(pt, llr, **kw)
    b = t_cuda.decode(pt, llr, **kw, _threads=64)
    for name in ("bits", "parity_ok", "iterations"):
        assert torch.equal(getattr(a, name), getattr(b, name))


def test_cluster_launches_have_rows_of_their_own():
    """``chip_smoke.py`` counts a compared one-codeword flooding case whose
    launch runs in a cluster (layout 2 or 3) for the cluster kernel's rows,
    one per instantiation, and the ``kernels`` line has a row for each
    cluster instantiation that a path launches; config #1's launch, which it
    holds to the plain version, shares each SM among smaller blocks."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rows", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    z384, p2 = TParams(**BG1_Z384), TParams(**P2)
    fl = dict(schedule="flooding")
    assert cs.case_variant("V3-SP", z384, 24, dict(fl, algorithm="sum-product"),
                           132) == "V3-SP-cluster"
    assert cs.case_variant("V4-flooding", z384, 264, dict(fl, algorithm="offset-min-sum"),
                           132) == "V3-NMS-cluster"
    assert cs.case_variant("V6-flooding", z384, 264, dict(fl, message_dtype="bfloat16"),
                           132) == "V6-flooding-cluster"
    assert cs.case_variant("V3-SP", p2, 2048, dict(fl, algorithm="sum-product"),
                           132) == "V3-SP"
    assert cs.case_variant("V1", z384, 24, {}, 132) == "V1"
    assert {"V3-SP-cluster", "V3-NMS-cluster"} <= {v for v, _, _ in cs.VARIANTS}
    shape = t_cuda.launch_shape(TParams(**cs.CONFIG1_FIELDS), cs.CONFIG1_BATCH, "flooding")
    assert shape["layout"] == t_cuda.LAYOUT_ON_CHIP
    assert shape["threads"] < t_cuda.FLOODING_MAX_THREADS


def test_one_codeword_kernel_has_two_barriers_per_sweep():
    """The one-codeword kernel: no barrier per base row and no separate
    syndrome pass; one vote after the message phase, one barrier after the
    column phase (and one after the initial load)."""
    src = _source()
    start = src.index("ldpc_flooding_kernel(const float*")
    body = src[start:src.index("// Layout (a): a thread block cluster")]
    assert "syndrome_bits" not in body and "check_row" not in body
    assert body.count("__syncthreads_or(") == 1
    assert body.count("__syncthreads();") == 2
    loop = body[body.index("for (int it = 0;; ++it)"):]
    assert loop.count("__syncthreads();") == 1
    # the cluster form: the same two phases, the vote then one cluster
    # barrier after the message phase, one after the column phase
    start = src.index("ldpc_flooding_cluster_kernel(const float*")
    body = src[start:src.index("// P codewords per block (P >= 2)")]
    assert "syndrome_bits" not in body and "check_row" not in body
    loop = body[body.index("for (int it = 0;; ++it)"):]
    assert loop.count("__syncthreads_or(") == 1 and loop.count("cluster.sync();") == 2
    assert "__syncthreads();" not in loop
