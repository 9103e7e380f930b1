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
from ldpc_3gpp_tpu_torch.tools import flooding_probe, layered_probe, small_z

P2 = dict(BG=2, A=3842, G=11526, Q_m=2)  # Z=208, the default decoder's step
BG1_Z384 = dict(BG=1, A=8424, G=25272, Q_m=2)
BG2_Z52 = dict(BG=2, A=400, G=1200, Q_m=2)
SNR_VS_A_A8000 = dict(BG=1, A=8000, G=24000, Q_m=2)  # Z=384, 424 fillers


def _source():
    with open(os.path.join(kernels_build.CSRC_DIR, "ldpc_flooding.cu")) as f:
        return f.read()


def _c_shared_bytes():
    """FLOODING_SHARED_BYTES of the CUDA source as a Python function: the
    macro's body with its casts dropped (the rest is valid Python)."""
    m = re.search(r"#define FLOODING_SHARED_BYTES\((.*?)\)(.*?)\n\n", _source(), re.S)
    names = [a.strip() for a in m.group(1).split(",")]
    body = m.group(2).replace("\\\n", " ").replace("(size_t)", "")
    deg = int(re.search(r"#define MAX_COLUMN_DEGREE (\d+)", _source()).group(1))
    return lambda *args: eval(  # noqa: S307 - the repository's own source
        body, {"align16": lambda n: -(-n // 16) * 16, "MAX_COLUMN_DEGREE": deg},
        dict(zip(names, args)))


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
    FLOODING_SHARED_BYTES at every lifting size of both base graphs (its
    float slots: the totals and messages, and the channel LLRs where they
    fit), and one block holds a codeword exactly up to BG2 Z=224 and BG1
    Z=144."""
    c_bytes = _c_shared_bytes()
    src = _source()
    assert f"#define FLOODING_MAX_THREADS {t_cuda.FLOODING_MAX_THREADS}" in src
    assert "return threads >= 32 && threads <= FLOODING_MAX_THREADS" in src
    seen = set()
    for fields in (BG1_Z384, P2):
        pt = TParams(**fields)
        nc, nr, E = pt.num_cols, pt.num_rows, len(pt.edges[0])
        for Z in ALL_LIFTING_SIZES:
            slots = t_cuda.one_block_slots(Z, nc, nr, E)
            assert t_cuda.shared_bytes("flooding", Z, nc, nr, E) == c_bytes(Z, nc, nr, E, slots)
            seen.add((pt.BG, Z, c_bytes(Z, nc, nr, E, nc + E) <= t_cuda.MAX_BLOCK_SHARED_BYTES))
    assert {(2, 224, True), (2, 240, False), (1, 144, True), (1, 160, False)} <= seen
    assert all(fits == (Z <= {1: 144, 2: 224}[bg]) for bg, Z, fits in seen)
    # the rule on a code's parameters is the same rule
    for bg, Z in ((2, 224), (2, 240), (1, 144), (1, 160)):
        pt = small_z.params_for_z(bg, Z)
        assert t_cuda.flooding_on_chip(pt) == ((bg, Z, True) in seen)
        layout = t_cuda.flooding_layout(pt)
        assert (layout == t_cuda.LAYOUT_ON_CHIP) == t_cuda.flooding_on_chip(pt)
        assert t_cuda.flooding_shared_bytes(pt, layout) <= t_cuda.MAX_BLOCK_SHARED_BYTES


# Every lifting size at which a codeword takes a cluster (one block holds up
# to BG1 Z=144 and BG2 Z=224).
CLUSTER_SHAPES = [(1, Z) for Z in ALL_LIFTING_SIZES if 160 <= Z <= 384] + [
    (2, Z) for Z in ALL_LIFTING_SIZES if 240 <= Z <= 384]


def _cluster_params(bg, Z):
    # BG1 Z=384 as snr_vs_a runs it at A=8000 (the benchmark cell's code)
    return TParams(**SNR_VS_A_A8000) if (bg, Z) == (1, 384) else small_z.params_for_z(bg, Z)


def _cluster_stats(pt, size):
    """Per block: rows' edges, owned columns, the column phase's edges, the
    slots held; and the remote edges (row and column in different blocks)."""
    row_lo, owner, slots_max = t_cuda._cluster_split(pt, size)
    Z, nr = pt.Z_c, pt.num_rows
    edges, row_start, _ = t_cuda._graph_plan(pt, tuple(range(nr)))
    cols = edges[:, 0] // Z
    block_of_edge = np.searchsorted(row_lo[1:], np.repeat(np.arange(nr), np.diff(row_start)),
                                    side="right")
    col_edges = [int((owner[cols] == q).sum()) for q in range(size)]
    ncols = [int((owner == q).sum()) for q in range(size)]
    return dict(row_lo=row_lo, owner=owner, slots_max=slots_max,
                row_edges=[int(row_start[row_lo[q + 1]] - row_start[row_lo[q]])
                           for q in range(size)],
                ncols=ncols, col_edges=col_edges,
                slots=[n + e for n, e in zip(ncols, col_edges)],
                remote=int((owner[cols] != block_of_edge).sum()))


def test_cluster_split_and_its_shared_bytes():
    """A cluster's blocks own contiguous rows (about E/size edges each) and
    every column exactly once, its total and all its edges' messages; no
    block of the chosen layout exceeds a block's shared memory at any
    cluster shape; the wrapper's bytes equal the source's
    FLOODING_CLUSTER_SHARED_BYTES, and the rule takes the fewest blocks that
    fit.  At BG1 Z=384 (snr_vs_a's A=8000) no block sums more than 150 of
    the 316 edges in the column phase, which reads no other block's shared
    memory, and at most 158 edges have their row and their column in
    different blocks (182 with contiguous thirds of the columns)."""
    m = re.search(r"#define FLOODING_CLUSTER_SHARED_BYTES\((.*?)\)(.*?)\n(?:#|\n)",
                  _source(), re.S)
    names = [a.strip() for a in m.group(1).split(",")]
    body = m.group(2).replace("\\\n", " ").replace("(size_t)", "")
    align16 = {"align16": lambda n: -(-n // 16) * 16}
    assert f"#define MAX_CLUSTER {t_cuda.MAX_CLUSTER}" in _source()
    assert f"#define OWNER_SHIFT {t_cuda.OWNER_SHIFT}" in _source()
    for bg, Z in CLUSTER_SHAPES:
        pt = _cluster_params(bg, Z)
        nc, nr, E = pt.num_cols, pt.num_rows, len(pt.edges[0])
        _, row_start, _ = t_cuda._graph_plan(pt, tuple(range(nr)))
        assert not t_cuda.flooding_on_chip(pt)
        layout = t_cuda.flooding_layout(pt)
        assert 2 <= layout <= t_cuda.MAX_CLUSTER
        for size in range(2, t_cuda.MAX_CLUSTER + 1):
            st = _cluster_stats(pt, size)
            row_lo, owner = st["row_lo"], st["owner"]
            assert row_lo.dtype == np.int32 and len(row_lo) == size + 1
            assert row_lo[0] == 0 and row_lo[-1] == nr and (np.diff(row_lo) > 0).all()
            # every row and every column has exactly one owner
            assert owner.shape == (nc,) and set(owner.tolist()) <= set(range(size))
            assert sum(st["ncols"]) == nc and sum(st["col_edges"]) == E
            assert max(st["row_edges"]) - min(st["row_edges"]) <= 2 * 19
            assert st["slots_max"] == max(st["slots"])
            want = eval(body, align16, dict(zip(names, (Z, nc, nr, E, st["slots_max"]))))  # noqa: S307
            assert t_cuda.flooding_shared_bytes(pt, size) == want
            if size == layout:
                assert max(st["slots"]) <= t_cuda._cluster_slots_cap(pt)
                assert want <= t_cuda.MAX_BLOCK_SHARED_BYTES, (bg, Z, size, want)
        assert t_cuda.flooding_shared_bytes(pt, layout) <= t_cuda.MAX_BLOCK_SHARED_BYTES
        assert t_cuda.flooding_shared_bytes(pt, layout - 1) > t_cuda.MAX_BLOCK_SHARED_BYTES
    # the layouts as before: 2 blocks up to BG1 Z=288 and BG2 Z=384, 3 above
    assert {(bg, Z): t_cuda.flooding_layout(_cluster_params(bg, Z)) for bg, Z in CLUSTER_SHAPES
            } == {(bg, Z): 3 if (bg, Z) >= (1, 320) and bg == 1 else 2
                  for bg, Z in CLUSTER_SHAPES}
    st = _cluster_stats(TParams(**SNR_VS_A_A8000), 3)
    assert max(st["col_edges"]) <= 150 and st["remote"] <= 158, st
    assert t_cuda.flooding_shared_bytes(TParams(**SNR_VS_A_A8000), 3) <= 232_448


def test_cluster_plan_encodes_the_split():
    """The plan the cluster kernel takes: the header (rows_lo, cols_lo), the
    column table (column, message offset, degree) block by block, and the
    edge table (owner << OWNER_SHIFT | total's offset, shift, message's
    offset) in row order; every total and message slot lies in its owner's
    slots, and each message slot belongs to exactly one edge."""
    for bg, Z in ((1, 384), (1, 160), (2, 240), (2, 384)):
        pt = _cluster_params(bg, Z)
        nc, nr, E = pt.num_cols, pt.num_rows, len(pt.edges[0])
        edges, row_start, _ = t_cuda._graph_plan(pt, tuple(range(nr)))
        col_edges, col_start = t_cuda._column_plan(pt)
        size = t_cuda.flooding_layout(pt)
        row_lo, owner, slots_max = t_cuda._cluster_split(pt, size)
        plan = t_cuda._cluster_plan(pt, size)
        H, W = t_cuda.MAX_CLUSTER + 1, t_cuda.CLUSTER_TABLE_WORDS
        assert plan.dtype == np.int32 and len(plan) == 2 * H + W * (nc + E)
        np.testing.assert_array_equal(plan[:size + 1], row_lo)
        assert (plan[size + 1:H] == nr).all() and (plan[H + size:2 * H] == nc).all()
        cols_lo = plan[H:H + size + 1]
        table = plan[2 * H:2 * H + W * nc].reshape(nc, W)
        etab = plan[2 * H + W * nc:].reshape(E, W)
        used = {}
        for q in range(size):
            mine = table[cols_lo[q]:cols_lo[q + 1]]
            np.testing.assert_array_equal(mine[:, 0], np.flatnonzero(owner == q))
            held = len(mine) + mine[:, 2].sum()
            assert held <= slots_max
            offset = len(mine)
            for j, (c, moff, deg, pad) in enumerate(mine):
                assert pad == 0 and moff == offset * Z and deg == col_start[c + 1] - col_start[c]
                slots = col_edges[col_start[c]:col_start[c + 1], 0] // Z  # ascending rows
                for k, e in enumerate(slots):
                    x, shift, mo, pad = etab[e]
                    assert x >> t_cuda.OWNER_SHIFT == q and x & 0xFFFFFF == j * Z
                    assert shift == edges[e, 1] and mo == (offset + k) * Z and pad == 0
                    used[(q, mo)] = used.get((q, mo), 0) + 1
                offset += deg
            assert offset == held
        assert len(used) == E and set(used.values()) == {1}


def _emulate_cluster(pt, llr, iterations, algorithm="min-sum"):
    """The cluster kernel's data movement on its plan, run to the budget on
    (n, num_cols*Z) 'cw' LLRs, with the plain decoder's check rule
    (``decoder_fast._check_messages``): each block's slots, the message
    phase reading an edge's total and message from the column's owner and
    storing the new message there by variable lane, the column phase summing
    a column's messages in its owner's slots in ascending row order.
    Returns (bits, parity_ok)."""
    import torch

    from ldpc_3gpp_tpu_torch.ops import decoder_fast

    Z, nc, nr, E = pt.Z_c, pt.num_cols, pt.num_rows, len(pt.edges[0])
    size = t_cuda.flooding_layout(pt)
    plan = t_cuda._cluster_plan(pt, size)
    slots_max = t_cuda._cluster_split(pt, size)[2]
    H, W = t_cuda.MAX_CLUSTER + 1, t_cuda.CLUSTER_TABLE_WORDS
    cols_lo = plan[H:H + size + 1]
    table = plan[2 * H:2 * H + W * nc].reshape(nc, W)
    etab = plan[2 * H + W * nc:].reshape(E, W)
    _, row_start, _ = t_cuda._graph_plan(pt, tuple(range(nr)))
    n = llr.shape[0]
    chan = llr.reshape(n, nc, Z)
    slots = [torch.full((n, slots_max, Z), float("nan")) for _ in range(size)]
    for q in range(size):
        for j in range(cols_lo[q], cols_lo[q + 1]):
            slots[q][:, j - cols_lo[q]] = chan[:, table[j, 0]]

    def at(e, word):  # (block, slot) of edge e's total (word 0) or message (2)
        x = int(etab[e, word])
        q = int(etab[e, 0]) >> t_cuda.OWNER_SHIFT
        return q, (x & 0xFFFFFF if word == 0 else x) // Z

    def parity():
        bad = torch.zeros(n, dtype=torch.bool)
        for r in range(nr):
            par = torch.zeros(n, Z, dtype=torch.bool)
            for e in range(row_start[r], row_start[r + 1]):
                q, s = at(e, 0)
                par ^= torch.roll(slots[q][:, s], -int(etab[e, 1]), dims=-1) < 0
            bad |= par.any(-1)
        return ~bad

    for it in range(iterations):
        new = []
        for r in range(nr):
            es = range(row_start[r], row_start[r + 1])
            v = []
            for e in es:
                (q, s), (_, ms) = at(e, 0), at(e, 2)
                t = torch.roll(slots[q][:, s], -int(etab[e, 1]), dims=-1)
                v.append(t if it == 0 else t - torch.roll(slots[q][:, ms], -int(etab[e, 1]),
                                                          dims=-1))
            new.append((es, decoder_fast._check_messages(v, algorithm, 0.8125, 0.15)))
        for es, ms in new:  # each message slot is its edge's alone
            for e, m in zip(es, ms):
                q, s = at(e, 2)
                slots[q][:, s] = torch.roll(m, int(etab[e, 1]), dims=-1)
        for q in range(size):
            for j in range(cols_lo[q], cols_lo[q + 1]):
                c, moff, deg, _ = table[j]
                acc = slots[q][:, moff // Z]
                for k in range(1, deg):
                    acc = acc + slots[q][:, moff // Z + k]
                slots[q][:, j - cols_lo[q]] = chan[:, c] + acc
    bits = torch.empty(n, nc, Z, dtype=torch.int8)
    for q in range(size):
        for j in range(cols_lo[q], cols_lo[q + 1]):
            bits[:, table[j, 0]] = (slots[q][:, j - cols_lo[q]] < 0).to(torch.int8)
    return bits.reshape(n, nc * Z), parity()


@pytest.mark.parametrize("bg,Z", [(1, 384), (1, 160), (2, 240)])
def test_cluster_plan_emulated_equals_the_plain_decoder(bg, Z):
    """The kernel's addressing on the plan, emulated with the plain check
    rule, gives the plain decoder's bits and parity bit for bit (min-sum,
    run to a budget of 3 sweeps; the rule's arithmetic is held on the card):
    every edge reads its column's total and its own message where the plan
    keeps them, and the column sums run in ascending row order."""
    import torch

    pt = _cluster_params(bg, Z)
    rng = np.random.default_rng(Z)
    n = 3
    llr = torch.from_numpy(rng.normal(0.6, 1.6, (n, pt.num_cols * Z)).astype(np.float32))
    llr[:, :2 * Z] = 0.0
    bits, ok = _emulate_cluster(pt, llr, 3)
    want = t_cuda.decode_plain(pt, llr, iterations=3, algorithm="min-sum", schedule="flooding",
                               early_termination=False)
    assert torch.equal(bits, want.bits) and torch.equal(ok, want.parity_ok)


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


@pytest.mark.parametrize("variant", sorted(flooding_probe.VARIANTS))
def test_flooding_probe_variants_patch_the_kernel_source(variant, tmp_path, monkeypatch):
    """Each variant of ``tools/flooding_probe.py`` finds each text it
    replaces in the kernel's source exactly as often as it says (the tool
    raises where it does not), changes only the cluster kernel, and only
    ``kernel`` leaves the source as it is."""
    monkeypatch.setattr(layered_probe, "PROBE_DIR", str(tmp_path))
    for name, old, _, count in flooding_probe.VARIANTS[variant]:
        assert name == flooding_probe.SOURCE
        assert _source().count(old) == count, (variant, old)
    src = flooding_probe.write_variant(variant)
    assert src == str(tmp_path / flooding_probe.FAMILY / variant / flooding_probe.SOURCE)
    with open(src) as f:
        text = f.read()
    with open(tmp_path / flooding_probe.FAMILY / variant / flooding_probe.HEADER) as f:
        header = f.read()
    with open(os.path.join(kernels_build.CSRC_DIR, flooding_probe.HEADER)) as f:
        assert f.read() == header
    orig = _source()
    assert (text == orig) == (variant == "kernel")
    # only ClusterEdges and the cluster kernel change
    end = orig.index("// Walks the items t, t + T, t + 2T, ... of a (major, row, lane)")
    assert text.startswith(orig[:orig.index("struct ClusterEdges")])
    assert text.endswith(orig[end:])


@pytest.mark.parametrize("variant", sorted(flooding_probe.ONE_BLOCK_VARIANTS))
def test_flooding_probe_one_block_variants_patch_the_kernel_source(variant, tmp_path, monkeypatch):
    """Each variant of the probe's ``one_block`` family finds each text it
    replaces in the kernel's source or the shared header exactly as often as
    it says, is written to the family's own folder, leaves the cluster
    kernel's text as it is, and only ``kernel`` leaves both files as they
    are."""
    monkeypatch.setattr(layered_probe, "PROBE_DIR", str(tmp_path))
    with open(os.path.join(kernels_build.CSRC_DIR, flooding_probe.HEADER)) as f:
        header = f.read()
    orig = {flooding_probe.SOURCE: _source(), flooding_probe.HEADER: header}
    for name, old, _, count in flooding_probe.ONE_BLOCK_VARIANTS[variant]:
        assert orig[name].count(old) == count, (variant, old)
    src = flooding_probe.write_variant(variant, "one_block")
    folder = tmp_path / flooding_probe.ONE_BLOCK_FOLDER / variant
    assert src == str(folder / flooding_probe.SOURCE)
    got = {name: (folder / name).read_text() for name in orig}
    assert (got == orig) == (variant == "kernel")
    cluster = orig[flooding_probe.SOURCE]
    cluster = cluster[cluster.index("// Layout (a): a thread block cluster"):
                      cluster.index("// Walks the items t, t + T, t + 2T, ... of a (major, row, lane)")]
    assert cluster in got[flooding_probe.SOURCE]


def test_flooding_probe_families_and_their_launches():
    """The probe's two families time the launches their cells make: the
    cluster kernel at snr_vs_a's A=8000 launch, the one-codeword kernel at
    config #1's (one block per codeword, several blocks per SM, the exact
    variants among the family's), and the command line takes the family
    first."""
    fams = flooding_probe.FAMILIES
    assert set(fams) == {"cluster", "one_block"}
    for family, (variants, folder, exact, entry, shape, _, kw, batches, reps, threads,
                 form) in fams.items():
        assert "kernel" in variants and set(exact) <= set(variants) and exact[0] == "kernel"
        assert kw["schedule"] == "flooding" and set(reps) == set(batches)
        pt = TParams(**shape)
        for n in batches:
            launch = t_cuda.launch_shape(pt, n, "flooding")
            assert launch["codewords_per_block"] == 1
            assert (launch["layout"] >= 2) == (form == "cluster"), (family, launch)
        assert all(T % 32 == 0 for T in threads)
    one = fams["one_block"]
    assert one[4] == dict(BG=2, A=100, G=200, Q_m=2) and one[5] == 2.0
    assert one[6]["algorithm"] == "min-sum" and one[6]["iterations"] == 50
    assert one[7] == (2048, 524288) and one[3].startswith("_Z20ldpc_flooding_kernelILb0ELb0E")
    z20 = TParams(**one[4])
    assert t_cuda.launch_shape(z20, 524288, "flooding")["threads"] < t_cuda.FLOODING_MAX_THREADS
