"""The one-codeword flooding kernel's form on the wrapper's side (the kernel
itself only runs on the card): its plan (rows and columns dealt in
descending degree, each column's messages in planes by rank, the channel
LLRs on chip where they fit), its shared-memory formula against the CUDA
source, and an emulation of the kernel's data movement on the plan held
against the plain decoder bit for bit, and once against the JAX package."""
import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder_fast as j_fast
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch import kernels_build
from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.ops import decoder_fast as t_fast
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.spec.tables import ALL_LIFTING_SIZES
from ldpc_3gpp_tpu_torch.tools import small_z
from test_torch_decoder import _assert_result_equal, _mixed_llrs

torch.set_num_threads(1)

CONFIG1 = dict(BG=2, A=100, G=200, Q_m=2)  # BASELINE config #1: Z=20, 84 fillers
P2 = dict(BG=2, A=3842, G=11526, Q_m=2)  # Z=208
BG1_Z384 = dict(BG=1, A=8424, G=25272, Q_m=2)


def _source():
    with open(os.path.join(kernels_build.CSRC_DIR, "ldpc_flooding.cu")) as f:
        return f.read()


def _unpack(pt):
    """The plan's parts: edge table (E, 4), column table (nc, 2), row
    offsets (nr + 1,), planes (MAX_COLUMN_DEGREE + 1,)."""
    plan = t_cuda._one_block_plan(pt)
    E, nc, nr = len(pt.edges[0]), pt.num_cols, pt.num_rows
    red = plan[:4 * E].reshape(E, 4)
    cols = plan[4 * E:4 * E + 2 * nc].reshape(nc, 2)
    rows = plan[4 * E + 2 * nc:4 * E + 2 * nc + nr + 1]
    planes = plan[4 * E + 2 * nc + nr + 1:]
    assert len(planes) == t_cuda.MAX_COLUMN_DEGREE + 1
    return red, cols, rows, planes


def _emulate(pt, llr, iterations=8, algorithm="min-sum", alpha=0.8125, beta=0.15,
             early_termination=True, alpha_schedule=None, message_dtype="float32"):
    """The one-codeword kernel's sweeps on its plan, for (n, num_cols*Z) 'cw'
    LLRs, with the plain decoder's check rule
    (``decoder_fast._check_messages``): the totals in the column table's
    order, every message at the plan's offset and variable lane, the message
    phase over the dealt rows (the parity of the totals it reads fused in;
    messages rounded to bfloat16 where read back), the vote, the column
    phase summing each column's planes in ascending row order.  A codeword
    that stops keeps the totals that were checked.  Returns (bits,
    parity_ok, iterations) as the kernel does."""
    red, cols, rows, planes = _unpack(pt)
    Z, nc, nr, E = pt.Z_c, pt.num_cols, pt.num_rows, len(pt.edges[0])
    n = llr.shape[0]
    chan = llr.reshape(n, nc, Z)[:, cols[:, 0]].reshape(n, nc * Z)
    totals = chan.clone()
    msgs = torch.full((n, E * Z), float("nan"))
    dtype = t_fast.MESSAGE_DTYPES[message_dtype]
    beta = float(np.float32(beta))
    z = np.arange(Z)

    def lanes(e):  # the edge's total and message, lane by lane of its check
        zl = np.where(z >= red[e, 2], z - Z, z)
        return red[e, 0] + zl, red[e, 1] + zl

    kept = totals.clone()
    ok = torch.zeros(n, dtype=torch.bool)
    used = torch.full((n,), iterations, dtype=torch.int32)
    live = torch.ones(n, dtype=torch.bool)
    for it in range(iterations + 1):
        update = it < iterations
        bad = torch.zeros(n, dtype=torch.bool)
        new = []
        alpha_t = t_fast._alpha_at(alpha, alpha_schedule, it)
        for p in range(nr):
            es = range(rows[p], rows[p + 1])
            t = [totals[:, lanes(e)[0]] for e in es]
            par = torch.zeros(n, Z, dtype=torch.bool)
            for te in t:
                par ^= torch.signbit(te)
            bad |= par.any(-1)
            if update:
                v = [te if it == 0 else te - msgs[:, lanes(e)[1]].to(dtype).to(torch.float32)
                     for e, te in zip(es, t)]
                new.append((es, t_fast._check_messages(v, algorithm, alpha_t, beta)))
        stop = live & ~bad & (early_termination or not update)
        kept[stop] = totals[stop]
        ok |= stop
        if early_termination:
            used[stop] = it
        live &= ~stop
        if not update or not live.any():
            break
        for es, ms in new:
            for e, m in zip(es, ms):
                msgs[:, lanes(e)[1]] = m
        for j in range(nc):
            i = j * Z + z
            acc = msgs[:, i]
            for k in range(1, cols[j, 1]):
                acc = acc + msgs[:, planes[k] + i]
            totals[:, i] = chan[:, i] + acc
    kept[live] = totals[live]
    bits = torch.empty(n, nc * Z, dtype=torch.int8)
    for j in range(nc):
        c = cols[j, 0]
        bits[:, c * Z:(c + 1) * Z] = (kept[:, j * Z:(j + 1) * Z] < 0).to(torch.int8)
    return bits, ok, used


def _levels(llr):
    """LLRs on six levels, +-0.5, +-1.5, +-2.5: rows tie at their smallest
    magnitude, and offset-min-sum with beta 0.5 gives zero magnitudes; no
    level is 0, so no LLR is -0.0 (punctured and filler positions kept)."""
    out = np.clip(np.floor(llr) + 0.5, -2.5, 2.5).astype(np.float32)
    keep = (llr == 0) | (llr == t_cuda.FILLER_LLR)
    out[keep] = llr[keep]
    return out


# (fields, LLR levels?, decode arguments): BG2 Z=20 (the channel LLRs on
# chip) and BG1 Z=144, the largest one-block Z of BG1 (too large for them)
EMULATED_CASES = {
    "z20_min_sum_et": (CONFIG1, False, dict(iterations=8)),
    "z20_offset_budget": (CONFIG1, False, dict(algorithm="offset-min-sum",
                                               early_termination=False, iterations=5)),
    "z20_bf16_min_sum_et": (CONFIG1, False, dict(message_dtype="bfloat16", iterations=8)),
    "z20_alpha_schedule": (CONFIG1, False, dict(alpha_schedule=(0.65, 2), iterations=6)),
    "z20_ties_min_sum": (CONFIG1, True, dict(iterations=6)),
    "z20_zero_magnitudes_offset_bf16": (CONFIG1, True, dict(
        algorithm="offset-min-sum", beta=0.5, message_dtype="bfloat16", iterations=6)),
    "z144_min_sum_et": ((1, 144), False, dict(iterations=12)),
    "z144_offset_bf16_budget": ((1, 144), True, dict(
        algorithm="offset-min-sum", beta=0.5, message_dtype="bfloat16",
        early_termination=False, iterations=3)),
}


def _params(fields):
    return small_z.params_for_z(*fields) if isinstance(fields, tuple) else TParams(**fields)


@pytest.mark.parametrize("name", sorted(EMULATED_CASES))
def test_emulated_one_block_form_equals_the_plain_decoder(name):
    """The kernel's addressing on its plan, emulated with the plain check
    rule, gives the plain decoder's bits, parity flags and iterations bit for
    bit (the rule's arithmetic is held on the card): every edge reads its
    column's total and its own message where the plan keeps them, the
    column sums run over the planes in ascending row order, and dealing rows
    and columns in descending degree changes nothing."""
    fields, levels, kw = EMULATED_CASES[name]
    pt = _params(fields)
    llr = _mixed_llrs(pt, seed=len(name))
    if levels:
        llr = _levels(llr)
    llr = torch.from_numpy(llr)
    got = _emulate(pt, llr, **kw)
    want = t_cuda.decode_plain(pt, llr, schedule="flooding", **kw)
    for g, w, what in zip(got, want, ("bits", "parity_ok", "iterations")):
        assert torch.equal(g, w), what
    ok = want.parity_ok.numpy()
    if kw.get("early_termination", True):
        assert ok.any() and not ok.all()  # both outcomes are exercised


def test_emulated_one_block_form_equals_jax_at_config1():
    """The same emulation at config #1's code (BG2 Z=20) against the JAX
    package's flooding min-sum decode."""
    pj, pt = JParams(**CONFIG1), TParams(**CONFIG1)
    llr = _mixed_llrs(pt, seed=11)
    kw = dict(iterations=8, algorithm="min-sum", alpha=0.8125)
    rj = jax.jit(partial(j_fast.decode, pj, **kw))(jnp.asarray(llr))
    bits, ok, used = _emulate(pt, torch.from_numpy(llr), **kw)
    _assert_result_equal(rj, t_cuda.DecodeResult(bits=bits, parity_ok=ok, iterations=used))
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("fields", [CONFIG1, P2, (1, 144), (2, 224)],
                         ids=["config1_z20", "p2_z208", "bg1_z144", "bg2_z224"])
def test_one_block_plan(fields):
    """Rows and columns dealt in descending degree (ties in ascending
    order), each row's edges in the reference's order; every edge's total
    is its column's, at its shift; every message slot belongs to exactly one
    edge, in the plane of its rank among its column's rows (ascending)."""
    pt = _params(fields)
    Z, nc, nr, E = pt.Z_c, pt.num_cols, pt.num_rows, len(pt.edges[0])
    red, cols, rows, planes = _unpack(pt)
    edges, row_start, _ = t_cuda._graph_plan(pt, tuple(range(nr)))
    row_deg = np.diff(row_start)
    col_deg = np.bincount(edges[:, 0] // Z, minlength=nc)
    row_order = sorted(range(nr), key=lambda r: (-row_deg[r], r))
    np.testing.assert_array_equal(np.diff(rows), row_deg[row_order])
    assert rows[0] == 0 and rows[-1] == E
    assert cols[:, 0].tolist() == sorted(range(nc), key=lambda c: (-col_deg[c], c))
    np.testing.assert_array_equal(cols[:, 1], col_deg[cols[:, 0]])
    position = {c: j for j, c in enumerate(cols[:, 0])}
    n_k = [(col_deg > k).sum() for k in range(t_cuda.MAX_COLUMN_DEGREE)]
    np.testing.assert_array_equal(np.diff(planes), Z * np.asarray(n_k))
    assert planes[0] == 0 and planes[-1] == E * Z
    slots = set()
    for p, r in enumerate(row_order):
        mine = red[rows[p]:rows[p + 1]]
        ref = edges[row_start[r]:row_start[r + 1]]
        for (x, y, w, pad), (c_z, s, _, _) in zip(mine, ref):
            c = c_z // Z
            j = position[c]
            assert pad == 0 and w == Z - s and x == j * Z + s
            rank = sum(1 for q in range(r) for e in edges[row_start[q]:row_start[q + 1]]
                       if e[0] == c_z)
            assert y == planes[rank] + j * Z + s and rank < col_deg[c]
            slots.add((y - s) // Z)
    assert len(slots) == E and slots == {(planes[k] + j * Z) // Z
                                         for j in range(nc) for k in range(col_deg[cols[j, 0]])}


def _c_shared_bytes():
    """FLOODING_SHARED_BYTES of the CUDA source as a Python function: the
    macro's body with its casts dropped (the rest is valid Python)."""
    src = _source()
    m = re.search(r"#define FLOODING_SHARED_BYTES\((.*?)\)(.*?)\n\n", src, re.S)
    names = [a.strip() for a in m.group(1).split(",")]
    body = m.group(2).replace("\\\n", " ").replace("(size_t)", "")
    deg = int(re.search(r"#define MAX_COLUMN_DEGREE (\d+)", src).group(1))
    return lambda *args: eval(  # noqa: S307 - the repository's own source
        body, {"align16": lambda n: -(-n // 16) * 16, "MAX_COLUMN_DEGREE": deg},
        dict(zip(names, args)))


def test_shared_bytes_follow_the_cuda_source_and_the_channel_rule():
    """The wrapper's one-block bytes equal the source's
    FLOODING_SHARED_BYTES at every lifting size of both base graphs, with
    the channel LLRs on chip exactly where the block then still fits; the
    one-block range stays BG2 Z <= 224, BG1 Z <= 144."""
    c_bytes = _c_shared_bytes()
    assert f"#define MAX_COLUMN_DEGREE {t_cuda.MAX_COLUMN_DEGREE}" in _source()
    for fields in (BG1_Z384, P2):
        pt = TParams(**fields)
        nc, nr, E = pt.num_cols, pt.num_rows, len(pt.edges[0])
        for Z in ALL_LIFTING_SIZES:
            slots = t_cuda.one_block_slots(Z, nc, nr, E)
            with_chan = c_bytes(Z, nc, nr, E, 2 * nc + E)
            assert slots == (2 * nc + E if with_chan <= t_cuda.MAX_BLOCK_SHARED_BYTES
                             else nc + E)
            assert t_cuda.shared_bytes("flooding", Z, nc, nr, E) == c_bytes(Z, nc, nr, E, slots)
    z20 = TParams(**CONFIG1)
    assert t_cuda.flooding_shared_bytes(z20, t_cuda.LAYOUT_ON_CHIP) == 27_948
    assert t_cuda._block_slots(z20, t_cuda.LAYOUT_ON_CHIP) == 2 * 52 + 197
    p2 = TParams(**P2)
    assert t_cuda._block_slots(p2, t_cuda.LAYOUT_ON_CHIP) == 52 + 197  # read from the input
    assert t_cuda.flooding_shared_bytes(p2, t_cuda.LAYOUT_ON_CHIP) <= t_cuda.MAX_BLOCK_SHARED_BYTES
    for bg, Z, fits in ((2, 224, True), (2, 240, False), (1, 144, True), (1, 160, False)):
        assert t_cuda.flooding_on_chip(small_z.params_for_z(bg, Z)) == fits


def test_config1_launch_fills_the_sm():
    """At config #1's launch a block takes 27,948 bytes, so 8 share an SM,
    each of 128 threads (the SM's 1,024 at 64 registers), from a
    bler_vs_snr call's 2,048 codewords to the cell's 524,288."""
    z20 = TParams(**CONFIG1)
    for n in (2048, 65536, 524288):
        assert t_cuda.launch_shape(z20, n, "flooding") == dict(
            codewords_per_block=1, threads=128, layout=t_cuda.LAYOUT_ON_CHIP)
    assert t_cuda.SM_SHARED_BYTES // (27_948 + t_cuda.BLOCK_RESERVED_BYTES) == 8
