"""The one-codeword layered min-sum kernel's form, on the CPU.

``csrc/ldpc_layered.cu::ldpc_layered_min_sum_kernel`` gives thread z check z
of every row, finds a row's words by a running offset in a (row, word, Z)
scratch, reads each edge's column offset at lane ``shift`` and its wrap lane
from its copy of the edge table (an address is ``.z + 4z - (z >= .w ? 4Z :
0)`` bytes), keeps the addresses of rows of up to ``KEPT_SLOTS`` edges for the
row's second pass, and subtracts the old messages without a ``first`` flag:
in sweep 0 the words are zero, so every old message is +0.0.  Here an
emulation of that form in torch (``_decode_form``: flat totals, the kernel's
edge table, the words' planes) is held to ``decode_plain`` bit for bit over
both base graphs at even and odd Z, 'd' and 'cw', both message types, both
rules, an alpha schedule, three row orders and tied LLRs, and once to the JAX
package.  Also: the address formula at every lifting size, the row groups
that ``tools/layered_probe.py``'s ``group_barriers`` uses, the tie rule of
its pairwise tree, and that the probe's variants leave the other kernels'
text alone.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder_layered as j_layered
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch import kernels_build
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.ops import decoder_layered as t_layered
from ldpc_3gpp_tpu_torch.ops.decoder import DecodeResult
from ldpc_3gpp_tpu_torch.ops.decoder_fast import _alpha_at, _row_plan
from ldpc_3gpp_tpu_torch.ops.decoder_layered import compress_row
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.spec.tables import ALL_LIFTING_SIZES
from ldpc_3gpp_tpu_torch.tools import layered_probe, layered_turns, small_z

from test_torch_layered_compressed import _mixed, _row_inputs

torch.set_num_threads(1)

SIGN = -(1 << 31)  # the sign bit of an int32
MAG = (1 << 31) - 1
MAG_INF = 0x7F7FFFFF
IDX_SHIFT = t_layered.MSG_IDX_SHIFT

# base graph, lifting size: 20 and 52 of each graph, and one odd Z of each
CODES = {
    "bg1_z20": (1, 20), "bg1_z52": (1, 52), "bg2_z20": (2, 20), "bg2_z52": (2, 52),
    "bg1_z13": (1, 13), "bg2_z15": (2, 15),
}


def _f32(x):
    return float(np.float32(x))


def _table(params, row_seq):
    """The kernel's shared-memory edge table: the plan's (col*Z, shift) and
    each edge's byte offset at lane ``shift`` and its wrap lane."""
    edges, row_start, _ = t_cuda._graph_plan(params, row_seq)
    x, s = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    return np.stack([x, s, 4 * (x + s), params.Z_c - s], axis=1), row_start


def _offsets(rec, Z):
    """Byte offsets of every lane's total for one edge record, as the kernel
    computes them."""
    z = torch.arange(Z, dtype=torch.int64)
    return int(rec[2]) + 4 * z - torch.where(z >= int(rec[3]), 4 * Z, 0)


def _as_f32(bits):
    return bits.contiguous().view(torch.float32)


def _as_i32(x):
    return x.contiguous().view(torch.int32)


def _decode_form(params, llr, iterations, algorithm="min-sum", alpha=0.8125, beta=0.15,
                 early_termination=True, layer_order="reversed", alpha_schedule=None,
                 message_dtype="float32", channel_format="cw", output_format="cw",
                 stats=None):
    """What ``ldpc_layered_min_sum_kernel`` computes for a batch of
    codewords, block by block (a codeword's block stops at its sweep), in
    the kernel's data: flat totals addressed in bytes, the edge table, the
    words' planes, zero words before their first store."""
    Z, nc, nr = params.Z_c, params.num_cols, params.num_rows
    row_seq = t_layered._resolve_layer_order(params, layer_order)
    table, row_start = _table(params, row_seq)
    flat = torch.arange(Z, dtype=torch.int64)  # thread z owns check z
    n = llr.shape[0]
    beta = _f32(beta)
    bf16 = message_dtype == "bfloat16"
    words = torch.zeros((n, nr, 2 if bf16 else 3, Z), dtype=torch.int32)

    # load_totals: 'd' input synthesises the punctured columns and pins fillers
    totals = torch.empty((n, nc * Z), dtype=torch.float32)
    for c in range(nc):
        if channel_format == "d":
            if c < 2:
                val = torch.zeros((n, flat.numel()))
            else:
                j = (c - 2) * Z + flat
                lo, hi = params.filler_range_d
                val = torch.where((j >= lo) & (j < hi), torch.tensor(t_cuda.FILLER_LLR,
                                  dtype=torch.float32), llr[:, j])
        else:
            val = llr[:, c * Z + flat]
        totals[:, c * Z + flat] = val

    def load_words(r):
        w = words[:, r][:, :, flat]
        if bf16:  # bfloat16 bits widen by a shift
            return w[:, 0] << 16, w[:, 0] & -65536, w[:, 1]
        return w[:, 0], w[:, 1], w[:, 2]

    def store_words(r, m1s, m2s, meta, live):
        if bf16:
            lo = _as_i32(_as_f32(m1s).to(torch.bfloat16).to(torch.float32)) >> 16 & 0xFFFF
            hi = _as_i32(_as_f32(m2s).to(torch.bfloat16).to(torch.float32)) >> 16 & 0xFFFF
            new = torch.stack([lo | (hi << 16), meta], dim=1)
        else:
            new = torch.stack([m1s, m2s, meta], dim=1)
        old = words[:, r][:, :, flat]
        words[:, r, :, flat] = torch.where(live[:, None, None], new, old)

    def row(r, a_t, live):
        """One row by every thread; returns each codeword's 'some check odd'."""
        e0, e1 = int(row_start[r]), int(row_start[r + 1])
        m1w, m2w, meta = load_words(r)
        old_idx = (meta >> IDX_SHIFT) & 31
        m1 = m2 = torch.full((n, flat.numel()), MAG_INF, dtype=torch.int32)
        idx = sx = signs = torch.zeros((n, flat.numel()), dtype=torch.int32)
        par = torch.zeros((n, flat.numel()), dtype=torch.int32)
        v, at = [], []
        for i, e in enumerate(range(e0, e1)):
            addr = _offsets(table[e], Z) // 4  # kept for the second pass (or recomputed)
            at.append(addr)
            t = totals[:, addr]
            par = par ^ _as_i32(t)
            old = torch.where(old_idx == i, m2w, m1w) ^ ((meta << (31 - i)) & SIGN)
            ve = t - _as_f32(old)  # sweep 0: zero words, t - (+0.0) == t
            v.append(ve)
            b = _as_i32(ve)
            mg = b & MAG
            sx = sx ^ b
            signs = signs | (((b >> 31) & 1) << i)
            if i == 0:
                m1 = mg
            else:
                idx = torch.where(mg < m1, i, idx)
                m2 = torch.minimum(m2, torch.maximum(m1, mg))
                m1 = torch.minimum(m1, mg)
        if algorithm == "offset-min-sum":
            m1f = torch.clamp_min(_as_f32(m1) - beta, 0.0)
            m2f = torch.clamp_min(_as_f32(m2) - beta, 0.0)
        else:
            m1f, m2f = a_t * _as_f32(m1), a_t * _as_f32(m2)
        if stats is not None:
            stats["zero_magnitudes"] += int((m1f == 0).sum())
        ssign = sx & SIGN
        m1s, m2s = _as_i32(m1f) ^ ssign, _as_i32(m2f) ^ ssign
        store_words(r, m1s, m2s, signs | (idx << IDX_SHIFT), live)
        for i, (ve, addr) in enumerate(zip(v, at)):
            msg = torch.where(idx == i, m2s, m1s) ^ (_as_i32(ve) & SIGN)
            new = ve + _as_f32(msg)
            totals[:, addr] = torch.where(live[:, None], new, totals[:, addr])
        return (par < 0).any(-1)

    def syndrome_bad():
        bad = torch.zeros(n, dtype=torch.bool)
        for r in range(nr):
            par = torch.zeros((n, flat.numel()), dtype=torch.int32)
            for e in range(int(row_start[r]), int(row_start[r + 1])):
                x, s = int(table[e, 0]), int(table[e, 1])  # syndrome_bits: rot
                par = par ^ _as_i32(totals[:, x + (flat + s) % Z])
            bad = bad | (par < 0).any(-1)
        return bad

    live = torch.ones(n, dtype=torch.bool)
    used = torch.full((n,), iterations, dtype=torch.int32)
    passed = torch.zeros(n, dtype=torch.bool)
    for it in range(iterations):
        a_t = _alpha_at(alpha, alpha_schedule, it)
        bad = torch.zeros(n, dtype=torch.bool)
        for r in range(nr):
            bad = bad | row(r, a_t, live)
        if early_termination:
            newly = live & ~bad
            used = torch.where(newly, it, used).to(torch.int32)
            passed = passed | newly
            live = live & bad
            if not bool(live.any()):
                break
    ok = passed | ~syndrome_bad()
    out_cols = params.num_sys_cols if output_format == "sys" else nc
    bits = (totals[:, : out_cols * Z] < 0).to(torch.int8)
    return DecodeResult(bits=bits, parity_ok=ok, iterations=used)


def _tied(llr, params):
    """LLRs on a grid of six levels, +-0.5, +-1.5, +-2.5 (as ``chip_smoke.tied``),
    the punctured columns kept at zero: rows tie at their smallest magnitude,
    and offset-min-sum with beta 0.5 gives zero magnitudes in every sweep."""
    out = torch.clamp(torch.floor(llr) + 0.5, -2.5, 2.5)
    out[:, : 2 * params.Z_c] = 0.0
    return out


def _permuted(params):
    return tuple(np.random.default_rng(params.num_rows).permutation(params.num_rows).tolist())


# (channel/output format, decode arguments, tied LLRs): min-sum with an alpha
# schedule in the reversed order, 'd' in and 'sys' out; offset-min-sum run to
# budget in the natural order, 'cw'; bfloat16 messages in a permuted order;
# offset-min-sum on tied LLRs with beta 0.5 (zero magnitudes, +-0.0 messages),
# bfloat16 messages, 'cw'
CASES = {
    "d_minsum_alpha_schedule_reversed": ("d", dict(iterations=10, alpha_schedule=(0.65, 2)), False),
    "cw_offset_budget_natural": ("cw", dict(iterations=6, algorithm="offset-min-sum",
                                            early_termination=False, layer_order="natural"),
                                 False),
    "d_bf16_permuted": ("d", dict(iterations=8, message_dtype="bfloat16", layer_order="permuted"),
                        False),
    "cw_tied_offset_zero_magnitudes_bf16": (
        "cw", dict(iterations=8, algorithm="offset-min-sum", beta=0.5,
                   message_dtype="bfloat16"), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("code", sorted(CODES))
def test_checks_form_equals_plain(code, case):
    """The emulated form equals ``decode_plain`` at tolerance 0 (bits,
    parity_ok, iterations)."""
    bg, Z = CODES[code]
    params = small_z.params_for_z(bg, Z)
    assert params.Z_c == Z
    fmt, kw, ties = CASES[case]
    kw = dict(kw)
    if kw.get("layer_order") == "permuted":
        kw["layer_order"] = _permuted(params)
    llr, d = _mixed(params, seed=3 + Z)
    if ties:
        llr = _tied(llr, params)
    src = d if fmt == "d" else llr
    io = dict(channel_format="d", output_format="sys") if fmt == "d" else {}
    stats = {"zero_magnitudes": 0}
    got = _decode_form(params, src, stats=stats, **io, **kw)
    want = t_cuda.decode_plain(params, src, **io, **kw)
    for name in ("bits", "parity_ok", "iterations"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if kw.get("early_termination", True):
        assert len(set(got.iterations.tolist())) > 1  # codewords stop at different sweeps
    if ties:
        assert stats["zero_magnitudes"] > 0


def test_checks_form_matches_jax():
    """One case of the emulated form against the JAX package's layered
    decoder (min-sum, early termination, reversed order), as
    ``test_torch_decoder.py::test_layered_decode_matches_jax`` runs it."""
    fields = dict(BG=2, A=100, G=300, Q_m=2)
    pj, pt = JParams(**fields), LDPCParams(**fields)
    llr, _ = _mixed(pt, seed=29)
    kw = dict(iterations=8)
    rj = jax.jit(partial(j_layered.decode, pj, **kw))(jnp.asarray(llr.numpy()))
    rt = _decode_form(pt, llr, **kw)
    for name in ("bits", "parity_ok", "iterations"):
        np.testing.assert_array_equal(np.asarray(getattr(rj, name)), getattr(rt, name).numpy(),
                                      err_msg=name)
    assert len(set(rt.iterations.tolist())) > 2


def test_table_addresses_are_the_rotation():
    """At every lifting size of TS38.212 and every shift, the kernel's byte
    offset .z + 4z - (z >= .w ? 4Z : 0) is 4 * (col*Z + (z + shift) mod Z),
    the rotation that ``syndrome_bits`` and the plain decoder apply; and the
    table of the flagship's plan holds exactly those records."""
    for Z in ALL_LIFTING_SIZES:
        z = torch.arange(Z, dtype=torch.int64)
        for shift in range(Z):
            for x in (0, 7 * Z):
                got = _offsets((x, shift, 4 * (x + shift), Z - shift), Z)
                assert torch.equal(got, 4 * (x + (z + shift) % Z)), (Z, shift, x)
    params = LDPCParams(BG=1, A=8424, G=25272, Q_m=2)
    table, row_start = _table(params, tuple(range(params.num_rows - 1, -1, -1)))
    edges, _, _ = t_cuda._graph_plan(params, tuple(range(params.num_rows - 1, -1, -1)))
    assert table.shape == (len(params.edges[0]), 4) and row_start[-1] == len(table)
    assert (table[:, :2] == edges[:, :2]).all() and (table[:, 3] >= 1).all()


def test_zero_words_leave_the_totals_exact():
    """Sweep 0 has no ``first`` flag: the zero words rebuild +0.0 for every
    edge, and t - (+0.0) == t bit for bit for every float32 the totals can
    hold, -0.0, subnormals and the filler value among them."""
    zero = torch.zeros(1, dtype=torch.int32)
    old = torch.where(zero == 0, zero, zero) ^ ((zero << 31) & SIGN)
    assert int(old) == 0
    rng = np.random.default_rng(0)
    t = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0,
        np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, t_cuda.FILLER_LLR, -t_cuda.FILLER_LLR,
                  np.finfo(np.float32).max], dtype=np.float32)]))
    assert torch.equal(_as_i32(t - _as_f32(old)), _as_i32(t))


@pytest.mark.parametrize("order", ("reversed", "natural", "permuted"))
@pytest.mark.parametrize("bg", (1, 2))
def test_row_groups_share_no_column(bg, order):
    """``layered_probe.row_groups``: the groups cover the row sequence in order, no two
    rows of a group share a column, and each group's first row shares one
    with the group before it (greedy); BG1 reversed 32 groups, BG2 28."""
    params = small_z.params_for_z(bg, 20)
    layer_order = _permuted(params) if order == "permuted" else order
    seq = t_layered._resolve_layer_order(params, layer_order)
    sizes = layered_probe.row_groups(params, seq)
    assert sum(sizes) == params.num_rows and min(sizes) >= 1
    by_row, _ = _row_plan(params)
    cols = [{c for (_, c, _) in by_row[r]} for r in seq]
    start, prev = 0, None
    for size in sizes:
        group = cols[start:start + size]
        union = set()
        for c in group:
            assert not union & c
            union |= c
        if prev is not None:
            assert prev & group[0]
        prev, start = union, start + size
    if order == "reversed":
        assert len(sizes) == {1: 32, 2: 28}[bg]


def _two_smallest(mg, lo, hi):
    """The probe's pairwise tree (``two_smallest`` of ``linear_vs_tree``)."""
    if hi - lo == 1:
        return mg[lo], torch.full_like(mg[lo], MAG_INF), torch.full_like(mg[lo], lo)
    mid = (lo + hi) // 2
    a1, a2, ai = _two_smallest(mg, lo, mid)
    b1, b2, bi = _two_smallest(mg, mid, hi)
    return (torch.minimum(a1, b1), torch.minimum(torch.maximum(a1, b1), torch.minimum(a2, b2)),
            torch.where(b1 < a1, bi, ai))


@pytest.mark.parametrize("deg", (9, 10, 19))
def test_tree_keeps_the_tournament_tie_rule(deg):
    """The tree over a row's slots (19 edges at MAX_DEG = 20 slots, the last
    a 0xffffffff leaf as in the probe's source) gives the running
    tournament's two smallest magnitudes and its index: ties to the lower
    edge, so the first edge at the smallest magnitude keeps ``idx``."""
    v = _row_inputs(deg, seed=deg + 100)
    mags = [_as_i32(x) & MAG for x in v]
    slots = 20 if deg == 19 else deg
    leaves = [m.to(torch.int64) for m in mags] + [
        torch.full_like(mags[0], 0xFFFFFFFF, dtype=torch.int64)] * (slots - deg)
    m1, m2, idx = _two_smallest(leaves, 0, slots)
    w1, w2, meta = compress_row(v, "min-sum", 1.0, 0.0)
    assert torch.equal(m1, (w1 & MAG).to(torch.int64))
    assert torch.equal(m2, (w2 & MAG).to(torch.int64))
    assert torch.equal(idx, ((meta >> IDX_SHIFT) & 31).to(torch.int64))
    assert bool((m1 == m2).any())  # ties at the smallest magnitude are exercised


def _source(name):
    with open(f"{kernels_build.CSRC_DIR}/{name}") as f:
        return f.read()


def _body(text, start, end):
    return text[text.index(start):text.index(end)]


@pytest.mark.parametrize("variant", sorted(layered_probe.VARIANTS))
def test_probe_variants_leave_the_other_kernels_alone(variant, tmp_path, monkeypatch):
    """No min-sum variant of the probe changes the text of the layered
    sum-product kernel (V2) or of the packed kernel (V7), and only those of
    the words' loads and stores change the shared header."""
    monkeypatch.setattr(layered_probe, "PROBE_DIR", str(tmp_path))
    src = layered_probe.write_variant(variant)
    got = open(src).read()
    header = open(tmp_path / variant / layered_probe.HEADER).read()
    assert (header == _source(layered_probe.HEADER)) == (not variant.startswith("words_"))
    orig = _source(layered_probe.SOURCE)
    for start, end in (("ldpc_layered_sp_kernel(const float*", "// P codewords per block"),
                       ("ldpc_layered_packed_kernel(const float*", "extern \"C\" int")):
        assert _body(got, start, end) == _body(orig, start, end), (variant, start)


def test_turns_tool_needs_two_sources_and_a_card(capsys):
    """``tools/layered_turns.py`` compares two or more sources and only on a
    card: with one source it exits 2, with no CUDA device 1."""
    assert layered_turns.main(["kernel=csrc"]) == 2
    if not torch.cuda.is_available():
        assert layered_turns.main(["parent=a", "change=b"]) == 1
    assert "layered_turns" in capsys.readouterr().err
