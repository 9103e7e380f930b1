"""The layered min-sum family's compressed messages (two magnitudes, a min
index and the sign bits per row and lane) against the port's plain row rule.

The CUDA kernel keeps a row's messages between sweeps as the words that
``ops.decoder_layered.compress_row`` models and rebuilds them as
``expand_row`` does.  Here, with no card and no JAX: the rebuilt messages
equal ``decoder_fast._check_messages`` (the rule ``ops.decoder_layered``
uses, held to JAX in ``test_torch_decoder.py``) bit for bit, and a whole
decode that keeps its messages only in those words equals
``ops.decoder_layered.decode`` at tolerance 0.  The kernel itself is held to
the plain version on the card by ``chip_smoke.py`` and by the ``cuda``-marked
test at the end.
"""
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu_torch.ops import decoder_cuda as t_cuda
from ldpc_3gpp_tpu_torch.ops import decoder_layered as t_layered
from ldpc_3gpp_tpu_torch.ops import encoder as t_enc
from ldpc_3gpp_tpu_torch.ops.decoder import DecodeResult
from ldpc_3gpp_tpu_torch.ops.decoder_fast import (
    _alpha_at, _check_messages, _row_plan, _syndrome_ok,
)
from ldpc_3gpp_tpu_torch.ops.decoder_layered import compress_row, expand_row
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.tools import small_z
from ldpc_3gpp_tpu_torch.tools import layered_probe

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# every row degree of BG1 and BG2
DEGREES = (3, 4, 5, 6, 7, 8, 9, 10, 19)
F32 = lambda x: float(np.float32(x))  # noqa: E731  (the rule takes f32 values)
# (algorithm, alpha, beta): both alpha values of an alpha_schedule (0.65, 2)
# beside the default 0.8125, offset-min-sum with the default beta, and with a
# beta at or above the smallest magnitudes (zero magnitudes, +-0.0 messages)
RULES = (
    ("min-sum", 0.8125, 0.15),
    ("min-sum", 0.65, 0.15),
    ("offset-min-sum", 0.8125, 0.15),
    ("offset-min-sum", 0.8125, 1.5),
)
Z20 = dict(BG=2, A=100, G=300, Q_m=2)  # Z=20, fillers
Z52 = dict(BG=2, A=400, G=1200, Q_m=2)  # Z=52


def _bits(x):
    return x.contiguous().view(torch.int32)


def _row_inputs(deg, seed, lanes=64):
    """A row's v_i, (2, lanes) float32 per edge, in three kinds of lanes:
    Gaussian values; two edges tied at the smallest magnitude (signs drawn);
    three edges tied there, on a grid of few levels.  No value is 0."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 2.0, (deg, 2, lanes)).astype(np.float32)
    third = lanes // 3
    # two ties: edges 1 and deg - 1 at 0.25, every other magnitude above 0.75
    v[:, :, third:2 * third] += np.sign(v[:, :, third:2 * third]) * 0.75
    sign = np.where(rng.random((2, 2, third)) < 0.5, -1, 1).astype(np.float32)
    v[1, :, third:2 * third] = sign[0] * 0.25
    v[deg - 1, :, third:2 * third] = sign[1] * 0.25
    # three ties on a grid: levels +-0.5, +-1.5, +-2.5, three edges at 0.5
    grid = np.clip(np.floor(v[:, :, 2 * third:]) + 0.5, -2.5, 2.5)
    grid = np.where(np.abs(grid) == 0.5, np.sign(grid) * 1.5, grid)
    picks = rng.permutation(deg)[:3]
    grid[picks] = np.sign(grid[picks]) * 0.5
    v[:, :, 2 * third:] = grid
    assert not (v == 0).any()
    return [torch.from_numpy(x) for x in v]


@pytest.mark.parametrize("message_dtype", sorted(DTYPES))
@pytest.mark.parametrize("deg", DEGREES)
def test_expanded_words_equal_the_plain_rule(deg, message_dtype):
    """expand_row(compress_row(v)) == the plain rule's per-edge messages,
    rounded to the message type, bit for bit: every row degree, both rules,
    ties of two and three edges at the smallest magnitude, and zero
    magnitudes under offset-min-sum."""
    dtype = DTYPES[message_dtype]
    v = _row_inputs(deg, seed=deg)
    zeros = [0, 0]  # +0.0 and -0.0 messages
    for algorithm, alpha, beta in RULES:
        want = _check_messages(v, algorithm, F32(alpha), F32(beta))
        words = compress_row(v, algorithm, F32(alpha), F32(beta), message_dtype)
        assert all(w.dtype == torch.int32 and w.shape == v[0].shape for w in words)
        got = expand_row(*words, deg)
        assert len(got) == deg
        for i, (g, w) in enumerate(zip(got, want)):
            w = w.to(dtype).to(torch.float32)
            assert torch.equal(_bits(g), _bits(w)), (algorithm, alpha, beta, i)
            zeros[0] += int(((w == 0) & ~torch.signbit(w)).sum())
            zeros[1] += int(((w == 0) & torch.signbit(w)).sum())
        # the index is the first edge at the smallest magnitude
        mags = torch.stack([x.abs() for x in v])
        first = torch.argmax((mags == mags.min(0).values).to(torch.int8), dim=0)
        assert torch.equal((words[2] >> t_layered.MSG_IDX_SHIFT) & 31, first.to(torch.int32))
    assert min(zeros) > 0  # the large beta gave zero magnitudes, of both signs


def test_ties_give_equal_magnitudes():
    """Where two edges tie at the smallest magnitude, m2s == m1s, so which of
    them gets m2s makes no difference."""
    v = _row_inputs(7, seed=1)
    m1s, m2s, meta = compress_row(v, "min-sum", F32(0.8125), F32(0.15))
    tied = slice(21, 42)
    assert torch.equal(m1s[:, tied], m2s[:, tied])
    assert not torch.equal(m1s[:, :21], m2s[:, :21])


def test_compressed_form_rejects_sum_product():
    v = _row_inputs(3, seed=0)
    with pytest.raises(ValueError):
        compress_row(v, "sum-product", 1.0, 0.0)


def _decode_compressed(params, llr, iterations, algorithm="min-sum", alpha=0.8125,
                       beta=0.15, early_termination=True, layer_order="reversed",
                       alpha_schedule=None, message_dtype="float32"):
    """``ops.decoder_layered.decode`` with every row's messages kept between
    sweeps only as the kernel's compressed words: old messages rebuilt by
    ``expand_row``, the rounded words stored, the totals given the unrounded
    messages (the float32 words)."""
    beta = F32(beta)
    row_seq = t_layered._resolve_layer_order(params, layer_order)
    Z, nc = params.Z_c, params.num_cols
    batch = llr.shape[:-1]
    blocks = llr.reshape(batch + (nc, Z))
    totals = [blocks[..., c, :] for c in range(nc)]
    by_row, _ = _row_plan(params)
    zero = torch.zeros(batch + (Z,), dtype=torch.int32)
    words = {r: (zero, zero, zero) for r in row_seq}

    def update_sweep(it, keep):
        sweep_ok = None
        a_t = _alpha_at(alpha, alpha_schedule, it)
        for r in row_seq:
            edges = by_row[r]
            t = [torch.roll(totals[c], -s, dims=-1) for (_, c, s) in edges]
            if early_termination:
                par = None
                for te in t:
                    par = (te < 0) if par is None else par ^ (te < 0)
                row_ok = ~par.any(dim=-1)
                sweep_ok = row_ok if sweep_ok is None else sweep_ok & row_ok
            old = expand_row(*words[r], len(edges))
            v = [te - o for te, o in zip(t, old)]
            stored = compress_row(v, algorithm, a_t, beta, message_dtype)
            exact = compress_row(v, algorithm, a_t, beta, "float32")
            nm = expand_row(*exact, len(edges))
            if keep is not None:
                stored = tuple(torch.where(keep, o, n) for o, n in zip(words[r], stored))
            words[r] = stored
            for i, (ve, (_, c, s)) in enumerate(zip(v, edges)):
                tn = ve + nm[i] if keep is None else torch.where(keep, t[i], ve + nm[i])
                totals[c] = torch.roll(tn, s, dims=-1)
        return sweep_ok

    if early_termination:
        done = torch.zeros(batch, dtype=torch.bool)
        used = torch.zeros(batch, dtype=torch.int32)
        it = 0
        while it <= iterations and not bool(done.all()):
            if it < iterations:
                sweep_ok = update_sweep(it, done.unsqueeze(-1))
            else:
                sweep_ok = _syndrome_ok(totals, by_row, row_seq)
            used = torch.where(sweep_ok & ~done, it, used).to(torch.int32)
            done = done | sweep_ok
            it += 1
        used = torch.where(done, used, iterations).to(torch.int32)
    else:
        for it in range(iterations):
            update_sweep(it, None)
        done = _syndrome_ok(totals, by_row, row_seq)
        used = torch.full(batch, iterations, dtype=torch.int32)
    bits = (torch.stack(totals, dim=-2) < 0).reshape(batch + (nc * Z,))
    return DecodeResult(bits=bits.to(torch.int8), parity_ok=done, iterations=used)


def _codeword_llrs(pt, n, sigma, seed):
    """(n, nc*Z) float32 LLRs of random codewords over BPSK-like AWGN, the
    2Z punctured positions zero and the fillers pinned, and the 'd' buffer
    of the same codewords (fillers left as received)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (n, pt.K)).astype(np.int8)
    c[:, pt.K_prime:] = 0
    cw = t_enc.encode(pt, torch.from_numpy(c)).numpy().astype(np.float32)
    y = (1.0 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = (2.0 * y / sigma**2).astype(np.float32)
    d = llr[:, 2 * pt.Z_c:].copy()
    llr[:, : 2 * pt.Z_c] = 0.0
    llr[:, pt.K_prime : pt.K] = t_cuda.FILLER_LLR
    return torch.from_numpy(llr), torch.from_numpy(d)


def _mixed(pt, seed):
    """Codewords that pass at various sweeps and noise that never passes."""
    parts = [_codeword_llrs(pt, 6, sigma, seed + k)
             for k, sigma in enumerate((0.8, 1.45, 1.7, 2.5))]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


# 'd' in / 'sys' out: min-sum with an alpha schedule, early termination,
# reversed order; 'cw' in and out: offset-min-sum run to budget, natural order
FORMATS = {
    "d": dict(iterations=10, algorithm="min-sum", alpha_schedule=(0.65, 2)),
    "cw": dict(iterations=6, algorithm="offset-min-sum", early_termination=False,
               layer_order="natural"),
}


@pytest.mark.parametrize("message_dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("fields", (Z20, Z52), ids=("z20", "z52"))
def test_decode_in_compressed_form_equals_plain(fields, fmt, message_dtype):
    """A whole decode whose messages live only in the compressed words equals
    the plain decoder at tolerance 0 (bits, parity_ok, iterations)."""
    pt = LDPCParams(**fields)
    llr, d = _mixed(pt, seed=7)
    kw = dict(FORMATS[fmt], message_dtype=message_dtype)
    got = _decode_compressed(pt, llr, **kw)
    if fmt == "d":
        want = t_cuda.decode_plain(pt, d, channel_format="d", output_format="sys", **kw)
        got = DecodeResult(bits=got.bits[:, : pt.num_sys_cols * pt.Z_c],
                           parity_ok=got.parity_ok, iterations=got.iterations)
    else:
        want = t_layered.decode(pt, llr, **kw)
    for name in ("bits", "parity_ok", "iterations"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if kw.get("early_termination", True):
        assert len(set(got.iterations.tolist())) > 2  # codewords stop at different sweeps


def test_scratch_shape_per_codeword():
    """The scratch ``decode`` gives a launch: 207 KiB (float32) and 138 KiB
    (bfloat16) of compressed words per codeword at BG1 Z=384, E*Z float32
    messages for sum-product (474 KiB); a packed launch's last block whole;
    none for the one-codeword flooding kernel, nor for a packed flooding
    launch whose messages fit on chip."""
    p = LDPCParams(BG=1, A=8424, G=25272, Q_m=2)
    assert p.Z_c == 384
    E = len(p.edges[0])

    def per_codeword(n, P=1, **kw):
        shape, dtype = t_cuda.scratch_shape(p, n, P=P, **kw)
        return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size() / (shape[0] * P)

    assert per_codeword(5) == 207 * 1024 == p.num_rows * 384 * 12
    assert per_codeword(5, message_dtype="bfloat16") == 138 * 1024
    assert per_codeword(5, algorithm="offset-min-sum") == 207 * 1024
    assert per_codeword(5, algorithm="sum-product") == E * 384 * 4 == 474 * 1024
    assert t_cuda.scratch_shape(p, 5) == ((5, p.num_rows, 3, 384), torch.int32)
    assert t_cuda.scratch_shape(p, 5, message_dtype="bfloat16")[0] == (5, p.num_rows, 2, 384)
    q = LDPCParams(**Z20)
    Eq = len(q.edges[0])
    assert t_cuda.scratch_shape(q, 53, P=4) == ((14, q.num_rows, 3, 80), torch.int32)
    assert t_cuda.scratch_shape(q, 53, "layered", "sum-product", P=4) == (
        (14, Eq, 80), torch.float32)
    # the packed flooding kernel keeps four Z=20 codewords' messages on chip;
    # where they do not fit (BG1 Z=96, two per block) it keeps each
    # codeword's E*Z unrounded messages, float32 also for bfloat16 messages
    assert t_cuda.scratch_shape(q, 53, "flooding", "min-sum", "bfloat16", P=4) is None
    z96 = small_z.params_for_z(1, 96)
    assert t_cuda.scratch_shape(z96, 53, "flooding", "min-sum", "bfloat16", P=2) == (
        (27, 2, E, 96), torch.float32)
    assert t_cuda.scratch_shape(q, 53, "flooding") is None


@pytest.mark.cuda
def test_kernel_on_tied_llrs_matches_plain_on_the_card():
    """The layered min-sum kernels equal their plain version on LLRs of few
    levels (rows tied at the smallest magnitude; offset-min-sum with zero
    magnitudes), one and four codewords per block, both message types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    pt = LDPCParams(**Z20)
    llr, _ = _mixed(pt, seed=5)
    llr = torch.clamp(torch.floor(llr) + 0.5, -2.5, 2.5)
    llr[:, : 2 * pt.Z_c] = 0.0
    llr = llr.cuda()
    for kw in (dict(algorithm="min-sum"),
               dict(algorithm="offset-min-sum", beta=0.5, message_dtype="bfloat16"),
               dict(algorithm="offset-min-sum", beta=0.5, early_termination=False)):
        for P in (1, 4):
            got = t_cuda.decode(pt, llr, iterations=12, codewords_per_block=P, **kw)
            want = t_cuda.decode_plain(pt, llr, iterations=12, **kw)
            for name in ("bits", "parity_ok", "iterations"):
                assert torch.equal(getattr(got, name), getattr(want, name)), (kw, P, name)


@pytest.mark.parametrize("variant", sorted(layered_probe.VARIANTS))
def test_probe_variants_patch_the_kernel_source(variant, tmp_path, monkeypatch):
    """Each variant of ``tools/layered_probe.py`` finds the text it replaces
    in the kernel's sources (the tool raises where it does not), and only
    ``kernel`` leaves them as they are."""
    monkeypatch.setattr(layered_probe, "PROBE_DIR", str(tmp_path))
    src = layered_probe.write_variant(variant)
    texts = [open(src).read(), open(tmp_path / variant / layered_probe.HEADER).read()]
    with open(t_cuda.kernels_build.CSRC_DIR + "/" + layered_probe.SOURCE) as f:
        same = f.read() == texts[0]
    with open(t_cuda.kernels_build.CSRC_DIR + "/" + layered_probe.HEADER) as f:
        same = same and f.read() == texts[1]
    assert same == (variant == "kernel")
