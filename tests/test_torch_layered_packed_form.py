"""The warp form of the packed layered min-sum kernel, on the CPU.

``csrc/ldpc_layered.cu::ldpc_layered_warp_kernel`` gives each warp G =
min(P, 32 // Z) codewords outright (lanes k*Z .. k*Z + Z - 1 for codeword
k) and a block ceil(P / G) such warps.  A warp's totals are laid out
(column, G*Z) in shared memory and its words (row, word, G*Z) beside them,
zeroed by each lane when it takes a codeword; an edge record carries the
byte offset 4 * (col*G*Z + shift) and the wrap lane Z - shift.  Rows are
separated by the warp's own barrier, a codeword votes over its lanes, and a
warp takes its next codewords from a counter when all its own are done; no
warp waits for another.  Here an emulation of that form in torch
(``_decode_warp_form``: the warps' flat state addressed as the kernel
addresses it, codewords taken in any order) is held to ``decode_plain`` bit
for bit
over both base graphs at Z in {2, 5, 8, 13, 16, 20, 32}, both message types,
both rules, 'd' and 'cw', a straggler mix and tied LLRs, and once to the
JAX package's interpreted kernel, which packs codewords into its tiles.
Also: the automatic rule at every lifting size, the shared-memory formula
against the source's, and that the probe's ``packed`` and ``packed_block``
variants leave the other kernels' text alone.
"""
import itertools
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder_pallas as j_pallas
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch import kernels_build
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.ops import decoder_layered as t_layered
from ldpc_3gpp_tpu_torch.ops.decoder import DecodeResult
from ldpc_3gpp_tpu_torch.ops.decoder_fast import _alpha_at
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.spec.tables import ALL_LIFTING_SIZES
from ldpc_3gpp_tpu_torch.tools import layered_probe, small_z

from test_torch_layered_compressed import _codeword_llrs
from test_torch_layered_min_sum_form import (
    IDX_SHIFT, MAG, MAG_INF, SIGN, _as_f32, _as_i32, _f32, _permuted, _tied,
)

torch.set_num_threads(1)

# every (base graph, Z) of the list that has a single-code-block code
CODES = {f"bg{bg}_z{Z}": (bg, Z) for bg in (1, 2) for Z in (2, 5, 8, 13, 16, 20, 32)
         if not (bg == 2 and Z == 2)}


def _lanes(Z, P):
    """(G, W, L): codewords per warp, warps per block, lanes of a warp's state."""
    G = t_cuda.warp_codewords(Z, P)
    return G, t_cuda.warp_count(Z, P), G * Z


def _table(params, row_seq, G):
    """The warp kernel's shared-memory edge table: the plan's (col*Z,
    shift), the byte offset 4 * (col*G*Z + shift) and the wrap lane."""
    edges, row_start, _ = t_cuda._graph_plan(params, row_seq)
    x, s = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    return np.stack([x, s, 4 * (x * G + s), params.Z_c - s], axis=1), row_start


def _word_index(params, P, N):
    """index(warp, row, word, lane) into a flat words array, as the kernel
    addresses them: each warp's (row, word, L) after its totals (the totals
    not counted here)."""
    _, _, L = _lanes(params.Z_c, P)
    nr = params.num_rows

    def index(warp, r, j, lane):
        return ((warp * nr + r) * N + j) * L + lane
    return index


def _decode_warp_form(params, llr, P, order=None, iterations=8,
                      algorithm="min-sum", alpha=0.8125, beta=0.15, early_termination=True,
                      layer_order="reversed", alpha_schedule=None, message_dtype="float32",
                      channel_format="cw", output_format="cw", stats=None):
    """What ``ldpc_layered_warp_kernel`` computes for a batch of codewords,
    warp by warp (all warps at once, each lane masked once its codeword is
    done), in the kernel's data.  ``order``: the slot each codeword is taken
    into (a permutation); results are returned in the caller's order."""
    Z, nc, nr = params.Z_c, params.num_cols, params.num_rows
    G, W, L = _lanes(Z, P)
    n = llr.shape[0]
    order = np.arange(n) if order is None else np.asarray(order)
    blocks = -(-n // P)
    NW = blocks * W
    bf16 = message_dtype == "bfloat16"
    N = 2 if bf16 else 3
    beta = _f32(beta)
    row_seq = t_layered._resolve_layer_order(params, layer_order)
    table, row_start = _table(params, row_seq, G)

    lane = torch.arange(L)
    k, z = lane // Z, lane % Z
    warp = torch.arange(NW)
    j = (warp % W)[:, None] * G + k[None, :]                 # codeword within its block
    slot = (warp // W)[:, None] * P + j                      # the kernel's cw
    active = (j < P) & (slot < n)
    src = torch.as_tensor(order)[slot.clamp(max=n - 1)]      # the codeword taken there
    z4 = 4 * lane

    def at(rec):
        """Indices in a warp's totals of one edge's column for every lane."""
        off = int(rec[2]) + z4 - torch.where(z >= int(rec[3]), 4 * Z, 0)
        return off // 4

    # load_totals_lanes
    totals = torch.zeros((NW, nc * L), dtype=torch.float32)
    for c in range(nc):
        if channel_format == "d":
            if c < 2:
                val = torch.zeros((NW, L))
            else:
                jd = (c - 2) * Z + z
                lo, hi = params.filler_range_d
                val = torch.where((jd >= lo) & (jd < hi), torch.tensor(t_cuda.FILLER_LLR),
                                  llr[src, jd[None, :].expand(NW, L)])
        else:
            val = llr[src, (c * Z + z)[None, :].expand(NW, L)]
        totals[:, c * L + lane] = torch.where(active, val, 0.0)

    # words: what the warp's last codeword left (garbage here); each lane
    # zeroes its own when it takes a codeword
    index = _word_index(params, P, N)
    words = torch.from_numpy(np.random.default_rng(5).integers(
        -2**31, 2**31, NW * nr * N * L, dtype=np.int64).astype(np.int32))
    widx = {(r, jj): index(warp[:, None], r, jj, lane[None, :])
            for r in range(nr) for jj in range(N)}
    for idx in widx.values():
        words[idx] = torch.where(active, 0, words[idx])

    def load(r):
        w = [words[widx[(r, jj)]] for jj in range(N)]
        if bf16:
            return w[0] << 16, w[0] & -65536, w[1]
        return w[0], w[1], w[2]

    def store(r, m1s, m2s, meta, live):
        if bf16:
            lo = _as_i32(_as_f32(m1s).to(torch.bfloat16).to(torch.float32)) >> 16 & 0xFFFF
            hi = _as_i32(_as_f32(m2s).to(torch.bfloat16).to(torch.float32)) >> 16 & 0xFFFF
            new = (lo | (hi << 16), meta)
        else:
            new = (m1s, m2s, meta)
        for jj, v in enumerate(new):
            idx = widx[(r, jj)]
            words[idx] = torch.where(live, v, words[idx])

    def row(r, a_t, live, first):
        e0, e1 = int(row_start[r]), int(row_start[r + 1])
        zero = torch.zeros((NW, L), dtype=torch.int32)
        m1w, m2w, meta = load(r)
        old_idx = (meta >> IDX_SHIFT) & 31
        m1 = m2 = torch.full((NW, L), MAG_INF, dtype=torch.int32)
        idx = sx = signs = par = torch.zeros((NW, L), dtype=torch.int32)
        v, addrs = [], []
        for i, e in enumerate(range(e0, e1)):
            addr = at(table[e])
            addrs.append(addr)
            t = totals[:, addr]
            par = par ^ _as_i32(t)
            old = torch.where(old_idx == i, m2w, m1w) ^ ((meta << (31 - i)) & SIGN)
            ve = t - _as_f32(old)
            v.append(ve)
            b = _as_i32(ve)
            mg = b & MAG
            sx, signs = sx ^ b, signs | (((b >> 31) & 1) << i)
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
            stats["zero_magnitudes"] += int(((m1f == 0) & live).sum())
        ssign = sx & SIGN
        m1s, m2s = _as_i32(m1f) ^ ssign, _as_i32(m2f) ^ ssign
        store(r, m1s, m2s, signs | (idx << IDX_SHIFT), live)
        for i, (ve, addr) in enumerate(zip(v, addrs)):
            msg = torch.where(idx == i, m2s, m1s) ^ (_as_i32(ve) & SIGN)
            totals[:, addr] = torch.where(live, ve + _as_f32(msg), totals[:, addr])
        return torch.where(live, par, 0)

    def by_codeword(lanes_bad):
        """A lane's codeword is odd where any of its lanes is (the vote)."""
        seg = lanes_bad.reshape(NW, G, Z).any(-1)
        return seg[:, k]

    done = ~active
    passed = torch.zeros((NW, L), dtype=torch.bool)
    used = torch.full((NW, L), iterations, dtype=torch.int32)
    for it in range(iterations):
        a_t = _alpha_at(alpha, alpha_schedule, it)
        bad = torch.zeros((NW, L), dtype=torch.int32)
        for r in range(nr):
            bad = bad | row(r, a_t, ~done, it == 0)
        if early_termination:
            odd = by_codeword((bad < 0) & ~done)
            newly = ~done & ~odd
            used = torch.where(newly, it, used).to(torch.int32)
            passed, done = passed | newly, done | newly
            if bool(done.all()):
                break
    # the final syndrome pass of the codewords that never passed
    sbad = torch.zeros((NW, L), dtype=torch.int32)
    for r in range(nr):
        par = torch.zeros((NW, L), dtype=torch.int32)
        for e in range(int(row_start[r]), int(row_start[r + 1])):
            par = par ^ _as_i32(totals[:, at(table[e])])
        sbad = sbad | par
    ok = passed | ~by_codeword((sbad < 0) & active & ~passed)

    out_cols = params.num_sys_cols if output_format == "sys" else nc
    bits = torch.zeros((n, out_cols * Z), dtype=torch.int8)
    parity = torch.zeros(n, dtype=torch.bool)
    iters = torch.zeros(n, dtype=torch.int32)
    for w in range(NW):
        for kk in range(G):
            lanes = slice(kk * Z, kk * Z + Z)
            if not bool(active[w, kk * Z]):
                continue
            cw = int(src[w, kk * Z])
            cols = torch.stack([totals[w, c * L + kk * Z: c * L + kk * Z + Z]
                                for c in range(out_cols)])
            bits[cw] = (cols.reshape(-1) < 0).to(torch.int8)
            parity[cw] = bool(ok[w, lanes][0])
            iters[cw] = int(used[w, lanes][0])
    return DecodeResult(bits=bits, parity_ok=parity, iterations=iters)


# noise levels of the straggler mix, four codewords each, by base graph: from
# codewords that pass in two sweeps to noise that never passes
MIX_SIGMAS = {1: (0.8, 1.0, 1.1, 1.2, 1.3, 2.5), 2: (0.8, 1.3, 1.5, 1.65, 1.8, 2.5)}


def _straggler_mix(params, seed):
    """24 codewords whose sweeps to convergence spread over the budget
    (three to seven distinct counts at 8 sweeps), a sixth of them noise."""
    parts = [_codeword_llrs(params, 4, sigma, seed + i)
             for i, sigma in enumerate(MIX_SIGMAS[params.BG])]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _assert_equal(got, want):
    for name in ("bits", "parity_ok", "iterations"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name


# (format, decode arguments, tied LLRs): min-sum in the reversed order, 'd'
# in and 'sys' out, early termination; offset-min-sum with bfloat16 messages
# run to budget in the natural order, 'cw'; bfloat16 messages with an alpha
# schedule in a permuted order, 'd'; offset-min-sum on tied LLRs with beta
# 0.5 (zero magnitudes, +-0.0 messages), 'cw'
CASES = {
    "d_minsum_f32": ("d", dict(iterations=8), False),
    "cw_offset_bf16_budget": (
        "cw", dict(iterations=5, algorithm="offset-min-sum", message_dtype="bfloat16",
                   early_termination=False, layer_order="natural"), False),
    "d_bf16_alpha_schedule_permuted": (
        "d", dict(iterations=8, message_dtype="bfloat16", alpha_schedule=(0.65, 2),
                  layer_order="permuted"), False),
    "cw_tied_offset_zero_magnitudes": (
        "cw", dict(iterations=8, algorithm="offset-min-sum", beta=0.5), True),
}


def _p(Z, ragged):
    """Codewords per block: the rule's at a bulk batch (or 4 where it does
    not pack), or one that leaves the last warp of a block (or the block's
    last codeword slot) ragged."""
    G = 32 // Z
    if ragged:
        return G + max(1, G // 2) if G > 1 else 3
    P = t_cuda.auto_codewords_per_block(small_z.params_for_z(2 if Z > 2 else 1, Z), 65536,
                                        "layered")
    return P if P > 1 else 4


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("code", sorted(CODES))
def test_warp_form_equals_plain(code, case):
    """The emulated warp form equals ``decode_plain`` at tolerance 0 (bits,
    parity_ok, iterations), at the rule's P or (every other case) a P that
    leaves a warp ragged, codewords taken in a shuffled order, the last
    block ragged (24 codewords)."""
    bg, Z = CODES[code]
    params = small_z.params_for_z(bg, Z)
    assert params.Z_c == Z
    fmt, kw, ties = CASES[case]
    kw = dict(kw)
    if kw.get("layer_order") == "permuted":
        kw["layer_order"] = _permuted(params)
    llr, d = _straggler_mix(params, seed=11 + Z)
    if ties:
        llr = _tied(llr, params)
    src = d if fmt == "d" else llr
    io = dict(channel_format="d", output_format="sys") if fmt == "d" else {}
    want = t_cuda.decode_plain(params, src, **io, **kw)
    order = np.random.default_rng(Z).permutation(src.shape[0])
    for P in (_p(Z, ragged=sorted(CASES).index(case) % 2 == 1),):
        assert t_cuda.warp_form(params, P, kw.get("algorithm", "min-sum"))
        stats = {"zero_magnitudes": 0}
        got = _decode_warp_form(params, src, P, order=order, stats=stats, **io, **kw)
        _assert_equal(got, want)
        if ties:
            assert stats["zero_magnitudes"] > 0
    if kw.get("early_termination", True):
        # stragglers: codewords of one warp stop at different sweeps, and some never pass
        assert len(set(want.iterations.tolist())) > 2 and not bool(want.parity_ok.all())


def test_warp_form_matches_jax():
    """The emulated form against the JAX package's layered kernel in
    interpret mode, which packs Z=20 codewords side by side in its tiles
    (``lane_pack``): min-sum with early termination, on the same
    numpy-seeded LLRs, four codewords per block (four warps)."""
    fields = dict(BG=2, A=100, G=300, Q_m=2)
    pj, pt = JParams(**fields), LDPCParams(**fields)
    assert j_pallas.supports(pj) and j_pallas._auto_pack(pj.Z_c) > 1
    llr, _ = _straggler_mix(pt, seed=31)
    kw = dict(iterations=8)
    rj = jax.jit(partial(j_pallas.decode, pj, interpret=True, schedule="layered", **kw))(
        jnp.asarray(llr.numpy()))
    rt = _decode_warp_form(pt, llr, 4, **kw)
    for name in ("bits", "parity_ok", "iterations"):
        np.testing.assert_array_equal(np.asarray(getattr(rj, name)),
                                      getattr(rt, name).numpy(), err_msg=name)
    assert len(set(rt.iterations.tolist())) > 2


def test_words_never_overlap():
    """Every (warp, row, word, lane) of a block has its own word, and a
    warp's words end within its state (``warp_state_bytes``: totals, then
    words), so that no warp touches another's."""
    for bg, Z, P in ((2, 20, 4), (2, 8, 12), (1, 13, 5), (1, 2, 16), (1, 32, 6)):
        params = small_z.params_for_z(bg, Z)
        assert t_cuda.warp_form(params, P)
        G, W, L = _lanes(Z, P)
        nr, nc = params.num_rows, params.num_cols
        index = _word_index(params, P, 3)
        seen = {index(w, r, j, lane) for w in range(W) for r in range(nr)
                for j in range(3) for lane in range(L)}
        assert len(seen) == W * nr * 3 * L and max(seen) == W * nr * 3 * L - 1
        per_warp = (t_cuda.warp_shared_bytes(Z, nc, nr, len(params.edges[0]), P, 3)
                    - t_cuda.warp_shared_bytes(Z, nc, nr, len(params.edges[0]), P, 0)) // W
        assert per_warp == nr * 3 * L * 4
        assert t_cuda.scratch_shape(params, 3 * P, "layered", "min-sum", "float32", P) == (
            (1,), torch.int32)  # the codeword counter


def test_automatic_rule_at_every_lifting_size():
    """At every lifting size and batch, with either message type, the rule's
    P fits a block (at most 384 lanes); where it packs the min-sum family it
    is the warp form and a block holds all P (sum-product keeps the packed
    kernel), and its result equals P=1 (the emulation at three sizes)."""
    for Z in ALL_LIFTING_SIZES:
        params = small_z.table_params(Z)
        for n, (algorithm, dtype) in itertools.product(
                (1, 256, 2048, 16384, 65536),
                (("min-sum", "float32"), ("min-sum", "bfloat16"),
                 ("offset-min-sum", "bfloat16"), ("sum-product", "float32"))):
            P = t_cuda.auto_codewords_per_block(params, n, "layered", algorithm, dtype)
            assert P >= 1 and t_cuda._fits("layered", params, P, algorithm, dtype)
            assert P * Z <= t_cuda.MAX_BLOCK_THREADS
            assert t_cuda.block_codewords(params, P, algorithm, dtype) == P
            assert t_cuda.resolve_codewords_per_block(params, n, "layered", 0,
                                                      algorithm, dtype) == P
            if P > 1 and algorithm != "sum-product":
                assert t_cuda.warp_form(params, P, algorithm)
            if Z > t_cuda.WARP_FORM_MAX_Z:
                assert P == 1
            if algorithm == "sum-product":  # the packed kernel's rule
                assert not t_cuda.warp_form(params, P, algorithm)
    for bg, Z in ((1, 2), (2, 8), (2, 20)):
        params = small_z.params_for_z(bg, Z)
        P = t_cuda.auto_codewords_per_block(params, 65536, "layered")
        llr, _ = _straggler_mix(params, seed=3)
        _assert_equal(_decode_warp_form(params, llr, P),
                      t_cuda.decode_plain(params, llr, iterations=8, codewords_per_block=P))


def _source(name=layered_probe.SOURCE):
    with open(f"{kernels_build.CSRC_DIR}/{name}") as f:
        return f.read()


def _c_function(src, name):
    """The return expression of a one-statement C function, or of the
    statement before its return: as Python (casts dropped)."""
    body = src[src.index(f" {name}("):]
    body = body[body.index("{") + 1:body.index("\n}")]
    return body.replace("(size_t)", "").replace("const size_t", "").strip()


def test_shared_bytes_formula_is_the_sources():
    """``warp_shared_bytes``, ``warp_form``, ``warp_max_warps`` and
    ``block_codewords`` are the source's formulas (warp_table_bytes,
    warp_state_bytes, warp_shared_bytes, warp_form, warp_max_warps,
    block_codewords, with the source's limits), and the figures of the
    design: one Z=20 codeword's words are 10,080 bytes and its state 14,240,
    four codewords with the edge table and row records 60,448, sixteen (one
    block per SM) 231,328; BG1 Z=32 at 12 codewords asked for holds 8 a
    block (what its shared memory holds), BG2 Z=32 with bfloat16 messages
    12 (384 lanes)."""
    src = _source()
    helpers = {"align16": lambda n: -(-n // 16) * 16, "min": min,
               "warp_codewords": t_cuda.warp_codewords, "warp_count": t_cuda.warp_count,
               "WARP_FORM_SHARED_LIMIT": int(re.search(
                   r"WARP_FORM_SHARED_LIMIT = (\d+);", src).group(1)),
               "MAX_THREADS": int(re.search(r"#define MAX_THREADS (\d+)",
                                            _source(layered_probe.HEADER)).group(1))}
    assert helpers["WARP_FORM_SHARED_LIMIT"] == t_cuda.MAX_BLOCK_SHARED_BYTES
    assert helpers["MAX_THREADS"] == t_cuda.MAX_BLOCK_THREADS

    def c_fn(name, args):
        text = _c_function(src, name).replace("(int)", "")
        stmts = [" ".join(st.split()).replace(" / ", " // ") for st in text.split(";")
                 if st.strip()]
        scope = dict(helpers)

        def fn(*values):
            local = dict(zip(args, values))
            for st in stmts[:-1]:
                lhs, rhs = st.split("=", 1)
                local[lhs.strip()] = eval(rhs, scope, local)  # noqa: S307 - the repo's source
            return eval(stmts[-1].replace("return", "", 1), scope, local)  # noqa: S307
        return fn

    helpers["warp_table_bytes"] = c_fn("warp_table_bytes", ("nr", "E"))
    helpers["warp_state_bytes"] = c_fn("warp_state_bytes", ("Z", "nc", "nr", "words", "P"))
    c_shared = c_fn("warp_shared_bytes", ("Z", "nc", "nr", "E", "P", "words"))
    helpers["warp_shared_bytes"] = c_shared
    helpers["WARP_FORM_MAX_THREADS"] = int(re.search(
        r"#define WARP_FORM_MAX_THREADS (\d+)", src).group(1))
    assert helpers["WARP_FORM_MAX_THREADS"] == t_cuda.WARP_FORM_MAX_THREADS
    c_max_warps = c_fn("warp_max_warps", ("Z", "nc", "nr", "E", "G", "words"))
    # the source's warp_form and block_codewords: the same conditions as
    # ``_warp_form`` and ``_block_codewords``
    assert _c_function(src, "warp_form") == (
        "return rule != RULE_SUM_PRODUCT && P > 1 && Z <= 32;")
    codewords = _c_function(src, "block_codewords")
    assert "if (!warp_form(rule, Z, P)) return P;" in codewords
    assert "return min(P, G * warp_max_warps(Z, nc, nr, E, G, N));" in codewords
    assert t_cuda.WARP_FORM_MAX_Z == 32
    for bg in (1, 2):
        params = small_z.params_for_z(bg, 8)
        nc, nr, E = params.num_cols, params.num_rows, len(params.edges[0])
        for Z in [z for z in ALL_LIFTING_SIZES if z <= 48]:
            for P in range(1, 24):
                G = t_cuda.warp_codewords(Z, P) if Z <= 32 else 0
                for words in (0, 2, 3) if G else ():
                    assert t_cuda.warp_shared_bytes(Z, nc, nr, E, P, words) == c_shared(
                        Z, nc, nr, E, P, words)
                    if words:
                        assert t_cuda.warp_max_warps(Z, nc, nr, E, G, words) == c_max_warps(
                            Z, nc, nr, E, G, words)
                for algorithm, dtype, words in (("min-sum", "float32", 3),
                                                ("offset-min-sum", "bfloat16", 2),
                                                ("sum-product", "float32", 3)):
                    form = algorithm != "sum-product" and P > 1 and Z <= 32
                    assert t_cuda._warp_form(Z, P, algorithm) == form
                    assert t_cuda._block_codewords(Z, nc, nr, E, P, algorithm, dtype) == (
                        min(P, G * c_max_warps(Z, nc, nr, E, G, words)) if form else P)
    q = small_z.table_params(20)
    nc, nr, E = q.num_cols, q.num_rows, len(q.edges[0])
    assert t_cuda.warp_shared_bytes(20, nc, nr, E, 1, 3) - t_cuda.warp_shared_bytes(
        20, nc, nr, E, 1, 0) == 10_080
    assert t_cuda.warp_shared_bytes(20, nc, nr, E, 4, 3) == 60_448 == t_cuda.shared_bytes(
        "layered", 20, nc, nr, E, 4)
    assert t_cuda.warp_shared_bytes(20, nc, nr, E, 16, 3) == 231_328
    assert t_cuda.launch_shape(q, 2048, "layered", 16) == dict(
        codewords_per_block=16, threads=512, layout=t_cuda.LAYOUT_ON_CHIP)
    assert t_cuda.launch_shape(q, 2048, "layered", 19) == dict(
        codewords_per_block=16, threads=512, layout=t_cuda.LAYOUT_ON_CHIP)
    assert t_cuda.scratch_shape(q, 8, P=4) == ((1,), torch.int32)
    b32 = small_z.params_for_z(1, 32)
    assert t_cuda.scratch_shape(b32, 24, P=12) == ((1,), torch.int32)
    assert t_cuda.launch_shape(b32, 24, "layered", 12) == dict(
        codewords_per_block=8, threads=256, layout=t_cuda.LAYOUT_ON_CHIP)
    z32 = small_z.params_for_z(2, 32)
    assert t_cuda.warp_form_warps(z32) == 10 and t_cuda.warp_form_warps(z32, "bfloat16") == 12
    assert t_cuda.launch_shape(z32, 4096, "layered", message_dtype="bfloat16") == dict(
        codewords_per_block=12, threads=384, layout=t_cuda.LAYOUT_ON_CHIP)
    assert t_cuda.launch_shape(q, 24, "layered", 4) == dict(
        codewords_per_block=4, threads=128, layout=t_cuda.LAYOUT_ON_CHIP)
    # sum-product keeps the packed kernel's block of P*Z lanes
    assert t_cuda.launch_shape(q, 24, "layered", 4, algorithm="sum-product") == dict(
        codewords_per_block=4, threads=96, layout=t_cuda.LAYOUT_SCRATCH)
    assert t_cuda.launch_shape(b32, 24, "layered", 12, algorithm="sum-product") == dict(
        codewords_per_block=12, threads=384, layout=t_cuda.LAYOUT_SCRATCH)


@pytest.mark.parametrize("message_dtype", ["float32", "bfloat16"])
def test_every_warp_form_block_fits(message_dtype):
    """Every P that may be asked for (P*Z within 384 lanes) at every lifting
    size up to 32 of both base graphs gives a warp-form block of at most P
    codewords within a block's threads (512) and its shared memory, and no
    fewer than one warp's codewords."""
    for bg, Z in itertools.product((1, 2), [z for z in ALL_LIFTING_SIZES if z <= 32]):
        try:
            params = small_z.params_for_z(bg, Z)
        except ValueError:
            continue
        nc, nr, E = params.num_cols, params.num_rows, len(params.edges[0])
        for P in range(2, t_cuda.MAX_BLOCK_THREADS // Z + 1):
            assert t_cuda._fits("layered", params, P, "min-sum", message_dtype)
            B = t_cuda.block_codewords(params, P, "min-sum", message_dtype)
            G = t_cuda.warp_codewords(Z, P)
            assert min(P, G) <= B <= P and t_cuda.warp_codewords(Z, B) == G
            shape = t_cuda.launch_shape(params, 4096, "layered", P, message_dtype=message_dtype)
            assert shape == dict(codewords_per_block=B, threads=t_cuda.warp_count(Z, B) * 32,
                                 layout=t_cuda.LAYOUT_ON_CHIP)
            assert shape["threads"] <= t_cuda.WARP_FORM_MAX_THREADS
            assert t_cuda.shared_bytes("layered", Z, nc, nr, E, P, message_dtype=message_dtype) \
                <= t_cuda.MAX_BLOCK_SHARED_BYTES


def _body(text, start):
    """The text of the __global__ function that begins at ``start``."""
    i = text.index(start)
    return text[i:text.index("\n}\n", i)]


KERNELS = ("ldpc_layered_min_sum_kernel(const float*", "ldpc_layered_sp_kernel(const float*",
           "ldpc_layered_packed_kernel(const float*", "ldpc_layered_warp_kernel(const float*")


@pytest.mark.parametrize("family,variant", [
    (f, v) for f in ("packed", "packed_block") for v in sorted(layered_probe.FAMILIES[f][0])])
def test_packed_probe_variants_leave_the_other_kernels_alone(family, variant, tmp_path,
                                                             monkeypatch):
    """A ``packed`` variant changes no __global__ kernel but the warp
    kernel, a ``packed_block`` variant none but the packed kernel; each finds
    its text (the tool raises where it does not)."""
    monkeypatch.setattr(layered_probe, "PROBE_DIR", str(tmp_path))
    got = open(layered_probe.write_variant(variant, family)).read()
    orig = _source()
    mine = KERNELS[3] if family == "packed" else KERNELS[2]
    for start in KERNELS:
        if start != mine:
            assert _body(got, start) == _body(orig, start), (variant, start)
    assert (got == orig) == (family == "packed" and variant == "kernel")
