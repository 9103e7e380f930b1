"""The packed flooding kernel (several codewords per block) and the layered
sum-product row, on the wrapper's side (the kernels only run on the card):
the deal of the block's items to the codewords still running, the vote, the
shared-memory formula against the CUDA source, the layout and block-size
rules, the explicit codewords per block that the wrapper accepts, and the
degrees that the sum-product row is unrolled to."""
import itertools
import os
import re
import types

import numpy as np
import pytest

from ldpc_3gpp_tpu_torch import kernels_build
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.spec.tables import ALL_LIFTING_SIZES
from ldpc_3gpp_tpu_torch.tools import layered_probe

BG1 = TParams(BG=1, A=8424, G=25272, Q_m=2)
BG2 = TParams(BG=2, A=3842, G=11526, Q_m=2)


def _read(name):
    with open(os.path.join(kernels_build.CSRC_DIR, name)) as f:
        return f.read()


def _packed_kernel_source():
    src = _read("ldpc_flooding.cu")
    start = src.index("ldpc_flooding_packed_kernel(const float*")
    return src[start:src.index('extern "C" int ldpc_flooding_max_degree()')]


def _walk3(t, T, Z, R, n):
    """The items thread ``t`` of ``T`` visits as ``ItemWalk3`` in
    csrc/ldpc_flooding.cu steps: (item, major, row, lane), the same integer
    arithmetic."""
    m = t // Z
    lane = t - m * Z
    major, row = divmod(m, R)
    m = T // Z
    d_lane = T - m * Z
    d_major, d_row = divmod(m, R)
    out = []
    for i in range(t, n, T):
        out.append((i, major, row, lane))
        lane += d_lane
        row += d_row
        major += d_major
        if lane >= Z:
            lane -= Z
            row += 1
        if row >= R:
            row -= R
            major += 1
    return out


@pytest.mark.parametrize("Z,R", [(2, 42), (20, 42), (20, 52), (52, 46), (384, 4)])
def test_item_walk_decomposes_every_item_once(Z, R):
    """Over all threads of a block, ``ItemWalk3`` visits every item of a
    (major, row, lane) range exactly once, as its plain decomposition."""
    for T in (32, 96, 128, 512, 1024):
        for n_major in (1, 3, 8):
            n = n_major * R * Z
            seen = [item for t in range(T) for item in _walk3(t, T, Z, R, n)]
            assert sorted(i for i, *_ in seen) == list(range(n))
            for i, major, row, lane in seen:
                assert (major, row, lane) == (i // (R * Z), i // Z % R, i % Z)


def _one_codeword(bad, iterations, et):
    """(ok, iterations) of one codeword as the one-codeword kernel leaves
    them, from its row parity at each of its passes (True: some row
    failed)."""
    for it in range(iterations + 1):
        update = it < iterations
        if not bad[it] and (et or not update):
            return 1, it if et else iterations
        if not update:
            return 0, iterations
    raise AssertionError("unreachable")


def _compact(live, keep):
    """Warp 0's new live list: the kept codewords in order, 32 at a time by
    a ballot and the population count below each lane."""
    out, n = [], 0
    for j0 in range(0, len(live), 32):
        chunk = live[j0:j0 + 32]
        mask = sum(1 << lane for lane, k in enumerate(chunk) if keep[k])
        for lane, k in enumerate(chunk):
            if keep[k]:
                assert len(out) == n + bin(mask & ((1 << lane) - 1)).count("1")
                out.append(k)
        n += bin(mask).count("1")
    return out


def _packed(bad, here, iterations, et, Z, nr, nc, T):
    """One block of the packed kernel, modelled sweep by sweep: the message
    items it deals over the live list, warp 0's vote (results, next list),
    the column items it runs (the same list, skipping the codewords that
    stopped at this vote).  Returns the results and, per sweep, (live,
    message items, column items run)."""
    live = list(range(here))
    results, sweeps = {}, []
    for it in itertools.count():
        update = it < iterations
        nl = len(live)
        msg = [(live[major], row, lane) for t in range(T)
               for _, major, row, lane in _walk3(t, T, Z, nr, nl * nr * Z)]
        flags = {k: bad[k][it] for k in live}
        keep = {k: update and (flags[k] or not et) for k in live}
        for k in live:
            if not keep[k]:
                assert k not in results  # a codeword stops once
                results[k] = (int(not flags[k]), it if et and not flags[k] else iterations)
        nxt = _compact(live, keep)
        if not update or (et and not any(flags.values())):
            sweeps.append((live, msg, []))
            assert not nxt
            break
        col = [(live[major], row, lane) for t in range(T)
               for _, major, row, lane in _walk3(t, T, Z, nc, nl * nc * Z)
               if not (et and not flags[live[major]])]
        sweeps.append((live, msg, col))
        live = nxt
    return results, sweeps


@pytest.mark.parametrize("P", [2, 4, 8])
def test_items_are_dealt_over_every_live_subset(P):
    """For every set of running codewords of a block (the live list, in
    order): the message phase deals every (codeword, row, lane) item of each
    exactly once and no other, the column phase every (codeword, column,
    lane) item, over all of the block's threads."""
    Z, nr, nc = 3, 4, 5
    for n_live in range(1, P + 1):
        for live in itertools.combinations(range(P), n_live):
            for T in (32, 96):
                for R in (nr, nc):
                    dealt = [(live[major], row, lane) for t in range(T)
                             for _, major, row, lane in _walk3(t, T, Z, R, n_live * R * Z)]
                    assert sorted(dealt) == [(k, r, z) for k in live for r in range(R)
                                             for z in range(Z)]


@pytest.mark.parametrize("P", [2, 4, 8])
def test_vote_keeps_each_codeword_as_the_one_codeword_kernel_leaves_it(P):
    """Codewords that pass at different votes, or never, in full and ragged
    last blocks, under both stopping rules: every codeword ends with the
    one-codeword kernel's parity flag and iteration count and stops once;
    each sweep deals every item of each running codeword exactly once, and
    the column phase runs the items of exactly the codewords that go on,
    which form the next sweep's live list."""
    Z, nr, nc, iterations = 2, 3, 4, 3
    rng = np.random.default_rng(P)
    for here in sorted({1, P - 1, P}):
        if here <= 4:
            cases = itertools.product(range(iterations + 2), repeat=here)
        else:
            cases = (tuple(rng.integers(0, iterations + 2, here)) for _ in range(150))
        for passes in cases:
            bad = {k: [it < passes[k] for it in range(iterations + 1)] for k in range(here)}
            for et in (True, False):
                results, sweeps = _packed(bad, here, iterations, et, Z, nr, nc, 32)
                assert results == {k: _one_codeword(bad[k], iterations, et)
                                   for k in range(here)}
                assert sweeps[0][0] == list(range(here))
                for live, msg, _ in sweeps:
                    assert sorted(msg) == [(k, r, z) for k in live for r in range(nr)
                                           for z in range(Z)]
                for (live, _, col), (nxt, _, _) in zip(sweeps, sweeps[1:]):
                    assert sorted(col) == [(k, c, z) for k in nxt for c in range(nc)
                                           for z in range(Z)]
                    assert set(nxt) <= set(live)


def test_packed_kernel_has_two_barriers_per_sweep():
    """Two barriers per sweep whatever the number of rows: the vote after the
    message phase, one after the column phase; no per-row barrier, no
    separate syndrome pass, no barrier in warp 0's vote or in code a
    codeword's state guards."""
    body = _packed_kernel_source()
    loop = body[body.index("for (int it = 0;; ++it)"):body.index("// every codeword's bits")]
    assert "check_row" not in body and "syndrome_bits" not in body
    assert loop.count("__syncthreads_or(") == 1 and loop.count("__syncthreads();") == 1
    assert body.count("__syncthreads") == 3  # and one after the initial load
    vote = loop[loop.index("if (t < 32) {"):loop.index("if (!update ||")]
    assert "__syncthreads" not in vote and "__ballot_sync(0xffffffffu" in vote
    assert not re.search(r"for \(int r = 0; r < nr;", loop)  # no loop over the rows
    # the items are those of the live list, over the whole block
    assert loop.count("lv[w.major]") == 3
    assert "message_item<SUM_PRODUCT, BF16>(" in loop and "parity_item(" in loop


def _c_packed_shared_bytes():
    m = re.search(r"#define FLOODING_PACKED_SHARED_BYTES\((.*?)\)(.*?)\n\n",
                  _read("ldpc_flooding.cu"), re.S)
    names = [a.strip() for a in m.group(1).split(",")]
    body = m.group(2).replace("\\\n", " ").replace("(size_t)", "")
    body = re.sub(r"\(\(on_chip\) \? \(E\) : 0\)", "((E) if (on_chip) else 0)", body)
    return lambda *args: eval(  # noqa: S307 - the repository's own source
        body, {"align16": lambda n: -(-n // 16) * 16}, dict(zip(names, args)))


def _code(p, Z):
    """A stand-in for ``p`` at lifting size Z: what the shared-memory and
    block rules read."""
    return types.SimpleNamespace(Z_c=Z, num_cols=p.num_cols, num_rows=p.num_rows,
                                 edges=p.edges)


def test_packed_shared_bytes_layout_and_scratch_follow_the_cuda_source():
    """The wrapper's packed formula equals FLOODING_PACKED_SHARED_BYTES on
    chip and with the messages in a scratch, at every lifting size and P
    that fits; the messages stay on chip where they fit (config #1's P=4:
    83,288 bytes, P=8: 163,032), else they go to a (blocks, P, E, Z)
    float32 scratch (BG1 Z=96, P=2), and ``decode``'s own assertion
    compares the same numbers."""
    c_bytes = _c_packed_shared_bytes()
    forms = set()
    for p in (BG1, BG2):
        nc, nr, E = p.num_cols, p.num_rows, len(p.edges[0])
        for Z in ALL_LIFTING_SIZES:
            code = _code(p, Z)
            for P in range(2, 384 // Z + 1):
                for on_chip in (True, False):
                    assert t_cuda.shared_bytes("flooding", Z, nc, nr, E, P, on_chip=on_chip) \
                        == c_bytes(Z, nc, nr, E, P, on_chip)
                if not t_cuda._fits("flooding", code, P):
                    continue
                layout = t_cuda.packed_flooding_layout(code, P)
                on_chip = layout == t_cuda.LAYOUT_ON_CHIP
                assert on_chip == (c_bytes(Z, nc, nr, E, P, True)
                                   <= t_cuda.MAX_BLOCK_SHARED_BYTES)
                assert t_cuda.flooding_shared_bytes(code, layout, P) == c_bytes(
                    Z, nc, nr, E, P, on_chip) <= t_cuda.MAX_BLOCK_SHARED_BYTES
                forms.add(on_chip)
    assert forms == {True, False}
    z20 = _code(BG2, 20)
    assert t_cuda.flooding_shared_bytes(z20, t_cuda.LAYOUT_ON_CHIP, 4) == 83_288
    assert t_cuda.flooding_shared_bytes(z20, t_cuda.LAYOUT_ON_CHIP, 8) == 163_032
    assert t_cuda.scratch_shape(z20, 2048, "flooding", "min-sum", "bfloat16", 4) is None
    z96 = _code(BG1, 96)
    assert t_cuda.packed_flooding_layout(z96, 2) == t_cuda.LAYOUT_SCRATCH
    assert t_cuda.scratch_shape(z96, 53, "flooding", "offset-min-sum", "bfloat16", 2) == (
        (27, 2, len(BG1.edges[0]), 96), t_cuda.torch.float32)
    assert t_cuda.scratch_shape(z96, 53, "flooding", "sum-product", "float32", 1) is None
    src = _read("ldpc_flooding.cu")
    assert "return (int)FLOODING_PACKED_SHARED_BYTES(Z, nc, nr, E, P, layout == 1);" in src
    assert "if ((P > 1 && layout == 0) != (c2v != nullptr))" in src


def test_packed_flooding_block_size_rule():
    """Whole warps up to the kernels' 1,024 threads at 64 registers, no more
    than the column phase's P*nc*Z items, the SM's threads split over the
    blocks its shared memory holds and half the launch's blocks give it;
    config #1's launch with P=4: two blocks of 512 per SM, with P=8 one of
    1,024."""
    for Z in (2, 5, 20, 52, 96):
        code = _code(BG2 if Z != 2 else BG1, Z)
        for P in (2, 4, 8):
            if not t_cuda._fits("flooding", code, P):
                continue
            for n in (53, 256, 2048, 16384):
                shape = t_cuda.launch_shape(code, n, "flooding", P)
                T = shape["threads"]
                assert shape["codewords_per_block"] == P
                assert shape["layout"] == t_cuda.packed_flooding_layout(code, P)
                assert T % 32 == 0 and 32 <= T <= t_cuda.FLOODING_MAX_THREADS
                assert T <= -(-(P * code.num_cols * Z) // 32) * 32
                smem = t_cuda.flooding_shared_bytes(code, shape["layout"], P)
                blocks = max(1, min(
                    t_cuda.SM_SHARED_BYTES // (smem + t_cuda.BLOCK_RESERVED_BYTES),
                    -(-(-(-n // P)) // (2 * 132))))
                assert T * blocks <= t_cuda.FLOODING_MAX_THREADS or T == 32
    z20 = _code(BG2, 20)
    assert t_cuda.flooding_threads(z20, 2048, P=4) == 512
    assert t_cuda.flooding_threads(z20, 2048, P=8) == 1024
    # one codeword per block is the rule it was
    assert t_cuda.flooding_threads(z20, 2048) == 128


def _parent_fits(schedule, code, P):
    """The codewords per block that the wrapper accepted before the packed
    flooding kernel kept its messages on chip: lanes in whole warps within
    384, and P sets of totals (and, flooding, of column sums) with the
    tables within a block's shared memory."""
    Z, nc, nr, E = code.Z_c, code.num_cols, code.num_rows, len(code.edges[0])
    if schedule == "flooding" and P == 1:
        return Z <= 384
    sets = 2 if schedule == "flooding" else 1
    smem = -(-(sets * P * nc * Z * 4) // 16) * 16 + E * 16 + (nr + 1) * 4 + (
        P * 4 if P > 1 else 0)
    return -(-(P * Z) // 32) * 32 <= 384 and smem <= 232_448


@pytest.mark.parametrize("schedule", t_cuda.SCHEDULES)
def test_every_explicit_codewords_per_block_is_still_accepted(schedule):
    """Every explicit ``codewords_per_block`` that the wrapper accepted
    before is accepted now, at every lifting size of both base graphs; the
    lane limit still refuses what it refused."""
    accepted = 0
    for p in (BG1, BG2):
        for Z in ALL_LIFTING_SIZES:
            code = _code(p, Z)
            for P in range(1, 2 * 384 // Z + 2):
                if _parent_fits(schedule, code, P):
                    assert t_cuda._fits(schedule, code, P), (p.BG, Z, P)
                    accepted += 1
                if -(-(P * Z) // 32) * 32 > 384:
                    assert not t_cuda._fits(schedule, code, P)
    assert accepted > 500


def test_sum_product_row_is_unrolled_to_every_row_degree():
    """The layered sum-product row is dispatched to its exact degree for
    every degree of BG2 (3, 4, 5, 6, 8, 10) and every BG1 degree up to 10;
    BG1's rows of 19 take MAX_DEG predicated slots.  Both layered kernels
    take the row through the dispatch, and nothing else of the decoders
    uses a row at MAX_DEG slots for every degree any more."""
    header = _read("ldpc_bp.cuh")
    row = header[header.index("unsigned layered_sp_row("):]
    row = row[:row.index("#undef SP_ROW_EXACT")]
    exact = {int(d) for d in re.findall(r"SP_ROW_EXACT\((\d+)\)", row)}
    assert exact == set(range(3, 11))
    assert "return layered_sp_row_slots<MAX_DEG>(" in row
    max_deg = int(re.search(r"#define MAX_DEG (\d+)", header).group(1))
    degrees = {}
    for p in (BG1, BG2):
        _, row_start, _ = t_cuda._graph_plan(p, tuple(range(p.num_rows)))
        degrees[p.BG] = set(np.diff(row_start).tolist())
    assert degrees[2] == {3, 4, 5, 6, 8, 10} and degrees[2] <= exact
    assert {d for d in degrees[1] if d <= 10} <= exact
    assert {d for d in degrees[1] if d > 10} == {19} and 19 <= max_deg
    layered = _read("ldpc_layered.cu")
    assert layered.count("bad |= layered_sp_row(") == 2
    assert "switch (deg) {" in row
    assert "check_row" not in layered and "check_row" not in header


def test_sum_product_keeps_four_blocks_per_sm_at_p3():
    """At P3's shape (BG2 Z=208, one codeword per block, 224 threads) the
    layered kernel's shared memory leaves four blocks on an SM; its 72
    registers (at most) are held on the card by ``chip_smoke.py``."""
    p3 = TParams(BG=2, A=2048, G=6144, Q_m=2)
    smem = t_cuda.shared_bytes("layered", 208, p3.num_cols, p3.num_rows, len(p3.edges[0]))
    assert smem == 46_588
    assert 4 * (smem + t_cuda.BLOCK_RESERVED_BYTES) <= t_cuda.SM_SHARED_BYTES
    assert t_cuda.launch_shape(p3, 1024, "layered")["threads"] == 224
    assert 4 * 224 * 72 <= 65_536


@pytest.mark.parametrize("variant", sorted(layered_probe.SP_VARIANTS))
def test_sum_product_probe_variants_patch_the_kernel_source(variant, tmp_path, monkeypatch):
    """Each sum-product variant of ``tools/layered_probe.py`` finds the text
    it replaces in the kernel's sources, and only ``kernel`` leaves them as
    they are; ``max_deg_slots`` is the row before the degree dispatch."""
    monkeypatch.setattr(layered_probe, "PROBE_DIR", str(tmp_path))
    src = layered_probe.write_variant(variant, "sum-product")
    out = tmp_path / "sum-product" / variant
    texts = [open(src).read(), open(out / layered_probe.HEADER).read()]
    same = (texts[0] == _read(layered_probe.SOURCE)
            and texts[1] == _read(layered_probe.HEADER))
    assert same == (variant == "kernel")
    assert ("  switch (0) {" in texts[1]) == (variant == "max_deg_slots")
    assert ("c2v[ed.z] = msg;" in texts[1]) == ("scratch" not in variant)
