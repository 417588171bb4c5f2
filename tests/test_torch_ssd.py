"""The port's Mamba-2 SSD against the JAX package's, on the CPU.

``ssd_chunk_scan_plain`` (what the ``ssd_chunk_scan`` wrapper runs on a CPU
tensor) is held against the JAX Pallas ``ssd_chunk_scan`` in interpret mode,
per sequence of the batch, and ``ops.ssd_scan`` against the JAX ``ops``
entry.  The tensor-core pass's arithmetic (C Bᵀ from exact bf16 products,
M and w ⊙ X as sums of bf16 terms) is emulated in
torch ops and held to chip_smoke's limits against the Pallas kernel, with a
one-term control that must fail the state limit; so is the short-chunk
pass's (C Bᵀ reduced in the kernel's order, float32 FMA), whose chunk
states at one-token chunks equal the plain version's bit for bit; so is
the inter-chunk scan kernel's (the chunks in order, C h_in from h_in's
three bf16 terms in steps of 16 as on the tensor cores, a multiply then an
add), whose final state equals the plain loop's bit for bit and whose y
is held against the Pallas kernel; so is the one-token-chunk kernel's (token by token from x, log_a,
b and c, the sum over N in its lanes' order, then a fixed tree over eight
lane groups), whose final state equals the plain version's bit for bit;
``ssd_route``, ``scan_route``, ``heads_per_block``, ``short_heads``,
``recur_grid`` and ``scan_chunks`` are checked by shape class.  Then the
smoke
``mamba2_2p7b`` with the JAX parameters carried over by
``params_from_numpy`` is held against the JAX prefill and decode, the Pallas
kernel again in interpret mode.

Tolerances: in float32 the outputs agree to 1e-5 of the largest |y| (sums
in another order); in bfloat16 both sides round y_intra and y to bf16 at
the same two places, so they agree to one bf16 ulp (2^-7 relative) of the
largest |y|.  The final states are float32 in both: 1e-5 relative.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels.ssd_chunk import ssd_chunk_scan as j_ssd
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.serve.engine import greedy_generate as j_generate
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_chunk as SC
from repro_torch.models import SINGLE, model_spec, param_count, params_from_numpy
from repro_torch.models.blocks import block_spec
from repro_torch.serve import greedy_generate, make_serve_fns

_BF16 = jnp.bfloat16


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _inputs(rng, batch, S, H=4, P=16, N=16):
    x = rng.normal(0, 1, (batch, S, H, P)).astype(np.float32)
    la = -rng.uniform(0.01, 0.5, (batch, S, H)).astype(np.float32)
    b = rng.normal(0, 0.5, (batch, S, N)).astype(np.float32)
    c = rng.normal(0, 0.5, (batch, S, N)).astype(np.float32)
    return x, la, b, c


def _chunk(S, chunk=32):
    """The reference's chunk rule (``models/ssd.py:126``)."""
    return min(chunk if S % min(chunk, S) == 0 else 1, S)


@pytest.mark.parametrize("S", [32, 64, 40])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_scan_plain_vs_pallas(S, batch, dtype):
    x, la, b, c = _inputs(_rng("ssd", S, batch, dtype), batch, S)
    L = _chunk(S)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else _BF16
    ty, th = SC.ssd_chunk_scan_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(la),
                                     torch.from_numpy(b).to(tdt), torch.from_numpy(c).to(tdt), L)
    assert ty.dtype == tdt and th.dtype == torch.float32
    for i in range(batch):
        jy, jh = j_ssd(jnp.asarray(x[i], jdt), jnp.asarray(la[i]), jnp.asarray(b[i], jdt),
                       jnp.asarray(c[i], jdt), chunk=L, interpret=True)
        jy = np.asarray(jy.astype(jnp.float32))
        scale = np.abs(jy).max()
        rel = 1e-5 if dtype == "float32" else 2.0**-7
        np.testing.assert_allclose(ty[i].float().numpy(), jy, rtol=0, atol=rel * scale)
        np.testing.assert_allclose(th[i].numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jh)).max())


@pytest.mark.parametrize("S,chunk", [(64, 32), (40, 1), (16, 32)])
def test_ssd_scan_entry_vs_reference_ops(S, chunk):
    """``ops.ssd_scan`` (batched) against the JAX ``ops.ssd_scan`` per
    sequence on the ``xla`` path; chunk is cut to S as in the reference."""
    x, la, b, c = _inputs(_rng("ops", S, chunk), 2, S)
    with tops.local_backend("torch"):
        ty, th = tops.ssd_scan(torch.from_numpy(x), torch.from_numpy(la),
                               torch.from_numpy(b), torch.from_numpy(c), chunk=chunk)
    for i in range(2):
        with jops.local_backend("xla"):
            jy, jh = jops.ssd_scan(jnp.asarray(x[i]), jnp.asarray(la[i]), jnp.asarray(b[i]),
                                   jnp.asarray(c[i]), chunk=chunk)
        np.testing.assert_allclose(ty[i].numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jy)).max())
        np.testing.assert_allclose(th[i].numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jh)).max())


def test_ssd_scan_rejects_a_chunk_that_does_not_divide():
    x, la, b, c = (torch.from_numpy(a) for a in _inputs(_rng("bad"), 1, 40))
    with pytest.raises(ValueError):
        tops.ssd_scan(x, la, b, c, chunk=32)


# ------------------------------------------- the tensor-core pass, emulated ----
def _bf16_terms(v, terms):
    """v (float32) as ``terms`` bf16 tensors whose sum approaches it."""
    out = []
    for _ in range(terms):
        out.append(v.to(torch.bfloat16))
        v = v - out[-1].float()
    return out


def _wgmma_emulated(x, la, b, c, L, m_terms=3, wx_terms=3):
    """``csrc/ssd_chunk.cu:ssd_wgmma``'s arithmetic in torch ops: the cumsum
    in sequential order; products of exact bf16 operands summed in float32;
    M = C Bᵀ ⊙ exp(cum_i - cum_j) as ``m_terms`` bf16 terms against X; the
    state as (w ⊙ X) in ``wx_terms`` bf16 terms against B.  → (y, h_final)
    through the port's inter-chunk scan."""
    bt, S, H, P = x.shape
    N, nc = b.shape[-1], S // L
    xf = x.float().reshape(bt, nc, L, H, P)
    bf, cf = b.float().reshape(bt, nc, L, N), c.float().reshape(bt, nc, L, N)
    cum = la.reshape(bt, nc, L, H).transpose(2, 3).cumsum(-1)  # (bt, nc, H, L)
    cb = cf @ bf.transpose(-1, -2)  # (bt, nc, i, j)
    d = cum[..., :, None] - cum[..., None, :]  # (bt, nc, H, i, j)
    d = torch.where(torch.ones(L, L, dtype=torch.bool).tril(), d, -torch.inf)
    m = cb[:, :, None] * torch.exp(d)
    y = sum(t.float() @ xf.transpose(2, 3) for t in _bf16_terms(m, m_terms))  # (bt,nc,H,L,P)
    w = torch.exp(cum[..., -1:] - cum)  # (bt, nc, H, L)
    wx = xf.transpose(2, 3) * w[..., None]  # (bt, nc, H, L, P)
    state = sum(bf[:, :, None].transpose(-1, -2) @ t.float() for t in _bf16_terms(wx, wx_terms))
    y = y.transpose(2, 3).reshape(bt, S, H, P).to(x.dtype)
    return SC.ssd_chunk_inter_plain(y, state, la, c)


def _pallas_per_sequence(x, la, b, c, L):
    ys, hs = [], []
    for i in range(x.shape[0]):
        jy, jh = j_ssd(jnp.asarray(x[i], _BF16), jnp.asarray(la[i]), jnp.asarray(b[i], _BF16),
                       jnp.asarray(c[i], _BF16), chunk=L, interpret=True)
        ys.append(np.asarray(jy.astype(jnp.float32)))
        hs.append(np.asarray(jh))
    return np.stack(ys), np.stack(hs)


def _errs(x, la, b, c, L, **terms):
    """(y err / max |y|, h err / max |h|) of the emulation against Pallas."""
    jy, jh = _pallas_per_sequence(x, la, b, c, L)
    ty, th = _wgmma_emulated(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(la),
                             torch.from_numpy(b).to(torch.bfloat16),
                             torch.from_numpy(c).to(torch.bfloat16), L, **terms)
    return (float(np.abs(ty.float().numpy() - jy).max() / np.abs(jy).max()),
            float(np.abs(th.numpy() - jh).max() / np.abs(jh).max()))


def _ssd_case(key, batch=2, S=192, H=3, P=16, N=64):
    x, la, b, c = _inputs(_rng("wgmma", key), batch, S, H, P, N)
    return x.astype(_BF16).astype(np.float32), la, b, c


@pytest.mark.parametrize("m_terms,wx_terms", [(3, 3), (2, 2), (1, 2)])
def test_wgmma_split_products_within_the_card_limits(m_terms, wx_terms):
    """L 64, N 64, P 16, bf16: M and w ⊙ X as bf16 terms (the kernel takes
    three of each) give y within chip_smoke's two bf16 ulps of max |y| and
    the final state within 1e-5 of max |h| of the Pallas kernel in
    interpret mode.  At this size two terms of w ⊙ X, and even one of M,
    meet these limits; the third terms are for the serving check (see
    csrc/ssd_chunk.cu)."""
    ey, eh = _errs(*_ssd_case("split"), 64, m_terms=m_terms, wx_terms=wx_terms)
    assert ey <= 2.0**-6 and eh <= 1e-5, (ey, eh)


def test_one_bf16_term_of_w_x_breaks_the_state_limit():
    """The control: w ⊙ X rounded to one bf16 term moves the final state
    far past 1e-5 of max |h|, so the limit sees the split."""
    ey, eh = _errs(*_ssd_case("split"), 64, m_terms=3, wx_terms=1)
    assert ey <= 2.0**-6 and eh > 1e-4, (ey, eh)


# ------------------------------------------- the short-chunk pass, emulated ----
def _fma(a, b, acc):
    """fmaf in float64: the product of two float32 values is exact there,
    so one rounding to float32 remains, as on the card (only a float64
    rounding that lands on a float32 tie could differ)."""
    return (a.double() * b.double() + acc.double()).float()


def _short_emulated(x, la, b, c, L):
    """``csrc/ssd_chunk.cu:ssd_short``'s arithmetic in torch ops → (y_intra,
    chunk states): C Bᵀ with lane l summing n = l, l + 32, … in turn, then
    the shuffle tree (offsets 16, 8, 4, 2, 1); the cumsum in sequential
    order; M = C Bᵀ ⊙ exp(cum_i - cum_j); y and the state summed over j in
    order with fmaf, b_j w_j rounded before its product, as in the kernel."""
    bt, S, H, P = x.shape
    N, nc = b.shape[-1], S // L
    xf = x.float().reshape(bt, nc, L, H, P)
    bf, cf = b.float().reshape(bt, nc, L, N), c.float().reshape(bt, nc, L, N)
    lanes = torch.zeros(bt, nc, L, L, 32)
    for n in range(N):
        lanes[..., n % 32] = _fma(cf[:, :, :, None, n], bf[:, :, None, :, n], lanes[..., n % 32])
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    cb = lanes[..., 0]  # (bt, nc, i, j)
    la4, acc = la.reshape(bt, nc, L, H), torch.zeros(bt, nc, H)
    cum = torch.zeros(bt, nc, L, H)
    for i in range(L):
        acc = acc + la4[:, :, i]
        cum[:, :, i] = acc
    w = torch.exp(cum[:, :, -1:] - cum)  # (bt, nc, L, H)
    causal = torch.ones(L, L, dtype=torch.bool).tril()[..., None]
    d = torch.where(causal, cum[:, :, :, None] - cum[:, :, None], 0.0)  # (bt, nc, i, j, H)
    m = torch.where(causal, cb[..., None] * torch.exp(d), 0.0)
    y = torch.zeros(bt, nc, L, H, P)
    state = torch.zeros(bt, nc, H, N, P)
    for j in range(L):  # a hidden entry adds 0 · x, which leaves the sum as it is
        y = _fma(m[:, :, :, j, :, None], xf[:, :, None, j], y)
        bw = bf[:, :, j, None, :] * w[:, :, j, :, None]  # (bt, nc, H, N)
        state = _fma(bw[..., None], xf[:, :, j, :, None, :], state)
    return y.reshape(bt, S, H, P).to(x.dtype), state


def _short_case(key, dtype, S, N, P, H=3, batch=2):
    x, la, b, c = _inputs(_rng("short", key, dtype, S, N, P), batch, S, H, P, N)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(la), torch.from_numpy(b).to(tdt),
            torch.from_numpy(c).to(tdt))


@pytest.mark.parametrize("L,S", [(1, 32), (2, 64), (8, 64), (16, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_chunk_pass_vs_pallas(L, S, dtype):
    """The short-chunk kernel's arithmetic at odd N 17 and P 7, through the
    port's inter-chunk scan, within chip_smoke's check_ssd limits of the
    Pallas kernel in interpret mode: y within two ulps of its type (bf16
    2^-6, float32 1e-5) of max |y|, the final state within 1e-5 of max
    |h|."""
    x, la, b, c = _short_case("pallas", dtype, S, 17, 7)
    ty, th = SC.ssd_chunk_inter_plain(*_short_emulated(x, la, b, c, L), la, c)
    jdt = jnp.float32 if dtype == "float32" else _BF16
    for i in range(x.shape[0]):
        jy, jh = j_ssd(jnp.asarray(x[i].float().numpy(), jdt), jnp.asarray(la[i].numpy()),
                       jnp.asarray(b[i].float().numpy(), jdt),
                       jnp.asarray(c[i].float().numpy(), jdt), chunk=L, interpret=True)
        jy, jh = np.asarray(jy.astype(jnp.float32)), np.asarray(jh)
        rel = 1e-5 if dtype == "float32" else 2.0**-6
        assert np.abs(ty[i].float().numpy() - jy).max() <= rel * np.abs(jy).max()
        assert np.abs(th[i].numpy() - jh).max() <= 1e-5 * np.abs(jh).max()


@pytest.mark.parametrize("N,P", [(17, 7), (128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_chunk_states_at_one_token_equal_the_plain_version(N, P, dtype):
    """At L = 1, w = exp(0) = 1 and each state entry is the one rounding of
    b_n x_p: the emulated kernel's chunk states equal the plain version's
    bit for bit; y differs at most by the order of c·b's sum."""
    x, la, b, c = _short_case("one", dtype, 24, N, P)
    ey, es = _short_emulated(x, la, b, c, 1)
    py, ps = SC.ssd_chunk_intra_plain(x, la, b, c, 1)
    assert torch.equal(es, ps)
    rel = 1e-5 if dtype == "float32" else 2.0**-7
    assert float((ey.float() - py.float()).abs().max()) <= rel * float(py.float().abs().max())


# ------------------------------------------- the inter-chunk scan, emulated ----
def _scan_emulated(y_intra, state, la, c):
    """``csrc/ssd_chunk.cu:ssd_scan``'s arithmetic in torch ops → (y,
    h_final): the chunks in order; C h_in as the tensor cores take it, h_in
    as three bf16 terms and C as one (bf16 values are exact) or three
    (float32), the term products whose orders add up to at most 2, summed
    over n in steps of 16 (each step's exact products summed in float64,
    then rounded into the float32 sum, steps in order, then the h terms,
    then the C terms); y = y_intra + exp(cum) * sum, then h = D h + S, a
    rounded multiply and then a rounded add, with exp(cum) from
    ``chunk_decays`` and D its last row."""
    bt, S, H, P = y_intra.shape
    nc, N = state.shape[1], state.shape[3]
    L = S // nc
    c_terms = 1 if c.dtype == torch.bfloat16 else 3
    ecum = SC.chunk_decays(la, nc)
    decay = ecum[:, :, -1]
    h = torch.zeros(bt, H, N, P)
    y = torch.empty(bt, S, H, P)
    for k in range(nc):
        cs = _bf16_terms(c[:, k * L:(k + 1) * L].float(), c_terms)  # (bt, L, N) each
        hs = _bf16_terms(h, 3)  # (bt, H, N, P) each
        total = torch.zeros(bt, L, H, P)
        for n in range(0, N, 16):
            for qh in range(3):
                for qc in range(min(c_terms, 3 - qh)):
                    step = torch.einsum("bln,bhnp->blhp", cs[qc][..., n:n + 16].double(),
                                        hs[qh][:, :, n:n + 16].double())
                    total = (total.double() + step).float()
        y[:, k * L:(k + 1) * L] = (y_intra[:, k * L:(k + 1) * L].float()
                                   + ecum[:, k, :, :, None] * total)
        h = decay[:, k, :, None, None] * h + state[:, k]
    return y.to(y_intra.dtype), h


_SCAN_CASES = [(1, 32), (128, 256)]  # (chunk, S): one-token chunks, and chunks of 128


@pytest.mark.parametrize("L,S", _SCAN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inter_chunk_scan_state_equals_the_plain_version(L, S, dtype):
    """The scan kernel's h_final, emulated at N 17 and P 7, equals the plain
    version's bit for bit: the same decays, then a multiply and an add,
    each rounded, chunk by chunk; y differs only by the order of C h_in's
    sum, within one ulp of its type of max |y|."""
    x, la, b, c = _short_case("scan", dtype, S, 17, 7)
    y_intra, state = SC.ssd_chunk_intra_plain(x, la, b, c, L)
    ey, eh = _scan_emulated(y_intra, state, la, c)
    py, ph = SC.ssd_chunk_inter_plain(y_intra, state, la, c)
    assert torch.equal(eh, ph)
    assert ey.dtype == py.dtype == x.dtype
    rel = 1e-5 if dtype == "float32" else 2.0**-7
    assert float((ey.float() - py.float()).abs().max()) <= rel * float(py.float().abs().max())


@pytest.mark.parametrize("L,S", _SCAN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inter_chunk_scan_vs_pallas(L, S, dtype):
    """The scan kernel's arithmetic, emulated over the plain intra-chunk
    pass at N 17 and P 7, against the Pallas ``ssd_chunk_scan`` in interpret
    mode, with the tolerances of ``test_ssd_chunk_scan_plain_vs_pallas``."""
    x, la, b, c = _short_case("scan pallas", dtype, S, 17, 7)
    ty, th = _scan_emulated(*SC.ssd_chunk_intra_plain(x, la, b, c, L), la, c)
    jdt = jnp.float32 if dtype == "float32" else _BF16
    for i in range(x.shape[0]):
        jy, jh = j_ssd(jnp.asarray(x[i].float().numpy(), jdt), jnp.asarray(la[i].numpy()),
                       jnp.asarray(b[i].float().numpy(), jdt),
                       jnp.asarray(c[i].float().numpy(), jdt), chunk=L, interpret=True)
        jy, jh = np.asarray(jy.astype(jnp.float32)), np.asarray(jh)
        rel = 1e-5 if dtype == "float32" else 2.0**-7
        np.testing.assert_allclose(ty[i].float().numpy(), jy, rtol=0,
                                   atol=rel * np.abs(jy).max())
        np.testing.assert_allclose(th[i].numpy(), jh, rtol=0, atol=1e-5 * np.abs(jh).max())


def test_inter_chunk_scan_wrapper_rejects_cpu_and_bad_shapes():
    """The kernel wrapper takes CUDA tensors only, and checks shapes first."""
    x, la, b, c = _short_case("scan reject", "float32", 32, 16, 8)
    y_intra, state = SC.ssd_chunk_intra_plain(x, la, b, c, 4)
    with pytest.raises(ValueError, match="device"):
        SC.ssd_chunk_inter(y_intra, state, la, c)
    bad = [(y_intra[:, :-4], state, la, c),  # S no longer matches log_a and c
           (y_intra, state[:, :, :2], la, c),  # heads
           (y_intra, state, la[:, :-1], c),
           (y_intra, state, la, c[..., :-1]),  # N
           (y_intra[..., :-1], state, la, c),  # P
           (y_intra, state[:, :3], la, c),  # chunks that do not divide S
           (y_intra[0], state, la, c)]  # rank
    for args in bad:
        with pytest.raises(ValueError, match="unsupported"):
            SC.ssd_chunk_inter(*args)
    wide = torch.zeros(2, 8, 3, 257, 8)  # N past SCAN_MAX_N
    with pytest.raises(ValueError, match="unsupported shapes"):
        SC.ssd_chunk_inter(y_intra, wide, la, torch.zeros(2, 32, 257))


def test_ssd_chunk_scan_on_cpu_runs_the_plain_inter_chunk_pass(monkeypatch):
    """A CPU tensor never reaches the kernel wrappers."""
    def refuse(*args):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(SC, "ssd_chunk_inter", refuse)
    monkeypatch.setattr(SC, "ssd_chunk_intra", refuse)
    monkeypatch.setattr(SC, "ssd_chunk_recur", refuse)
    x, la, b, c = _short_case("scan cpu", "float32", 32, 16, 8)
    before = SC.launches_scan.value
    y, h = SC.ssd_chunk_scan(x, la, b, c, 8)
    want = SC.ssd_chunk_scan_plain(x, la, b, c, 8)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert SC.launches_scan.value == before


# ------------------------------------------- the one-token-chunk kernel, emulated ----
def _lane_tree(parts):
    """The eight lane groups' sums as ssd_recur's shuffle stages add them
    (lane offsets 16, 8, 4): ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))."""
    return (((parts[0] + parts[4]) + (parts[2] + parts[6]))
            + ((parts[1] + parts[5]) + (parts[3] + parts[7])))


def _recur_emulated(x, la, b, c):
    """``csrc/ssd_chunk.cu:ssd_recur``'s arithmetic in torch ops → (y,
    h_final), token by token from h = 0: lane group j sums c_t[n] h[n, p]
    over its n = 32 k + 4 j + i (k, then i) with fmaf, n past N being 0;
    the eight groups' sums by ``_lane_tree``; h = d h + b xᵀ as a rounded
    multiply, a rounded product and a rounded add; c·b with lane l summing n
    = l, l + 32, … with fmaf, then the shuffle tree (offsets 16, 8, 4, 2,
    1); y = round(round(c·b x) + e * sum), d = e = ``chunk_decays`` at
    chunk 1."""
    bt, S, H, P = x.shape
    N = b.shape[-1]
    K = next(k for k in (1, 2, 4, 8) if N <= 32 * k)
    pad = (0, 32 * K - N)
    xf = x.float()
    bf = torch.nn.functional.pad(b.float(), pad)
    cf = torch.nn.functional.pad(c.float(), pad)
    e = SC.chunk_decays(la, S)[:, :, 0]  # (bt, S, H)
    lanes = torch.zeros(bt, S, 32)
    for n in range(N):
        lanes[..., n % 32] = _fma(cf[..., n], bf[..., n], lanes[..., n % 32])
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    cb = lanes[..., 0]  # (bt, S)
    h = torch.zeros(bt, H, 32 * K, P)
    y = torch.empty(bt, S, H, P)
    for t in range(S):
        parts = []
        for j in range(8):
            s = torch.zeros(bt, H, P)
            for k in range(K):
                for i in range(4):
                    n = 32 * k + 4 * j + i
                    s = _fma(cf[:, t, n, None, None], h[:, :, n], s)
            parts.append(s)
        yi = (cb[:, t, None, None] * xf[:, t]).to(x.dtype).float()
        y[:, t] = yi + e[:, t, :, None] * _lane_tree(parts)
        h = e[:, t, :, None, None] * h + bf[:, t, None, :, None] * xf[:, t, :, None, :]
    return y.to(x.dtype), h[:, :, :N]


@pytest.mark.parametrize("N,P", [(17, 7), (128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recur_state_equals_the_plain_version(N, P, dtype):
    """The one-token-chunk kernel's h_final, emulated from x, log_a, b and
    c, equals ``ssd_chunk_scan_plain(..., 1)``'s bit for bit: each step is
    the plain loop's round(round(d h) + round(b x)); y differs only by the
    order of c·b's and c·h's sums, within one ulp of its type of max |y|."""
    x, la, b, c = _short_case("recur", dtype, 24, N, P, H=2)
    ey, eh = _recur_emulated(x, la, b, c)
    py, ph = SC.ssd_chunk_scan_plain(x, la, b, c, 1)
    assert torch.equal(eh, ph)
    assert ey.dtype == py.dtype == x.dtype
    rel = 1e-5 if dtype == "float32" else 2.0**-7
    assert float((ey.float() - py.float()).abs().max()) <= rel * float(py.float().abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recur_vs_pallas(dtype):
    """The one-token-chunk kernel's arithmetic, emulated at N 17 and P 7,
    against the Pallas ``ssd_chunk_scan`` at chunk 1 in interpret mode, with
    the tolerances of ``test_ssd_chunk_scan_plain_vs_pallas``."""
    x, la, b, c = _short_case("recur pallas", dtype, 32, 17, 7)
    ty, th = _recur_emulated(x, la, b, c)
    jdt = jnp.float32 if dtype == "float32" else _BF16
    for i in range(x.shape[0]):
        jy, jh = j_ssd(jnp.asarray(x[i].float().numpy(), jdt), jnp.asarray(la[i].numpy()),
                       jnp.asarray(b[i].float().numpy(), jdt),
                       jnp.asarray(c[i].float().numpy(), jdt), chunk=1, interpret=True)
        jy, jh = np.asarray(jy.astype(jnp.float32)), np.asarray(jh)
        rel = 1e-5 if dtype == "float32" else 2.0**-7
        np.testing.assert_allclose(ty[i].float().numpy(), jy, rtol=0,
                                   atol=rel * np.abs(jy).max())
        np.testing.assert_allclose(th[i].numpy(), jh, rtol=0, atol=1e-5 * np.abs(jh).max())


def test_recur_wrapper_rejects_cpu_and_bad_shapes():
    """``ssd_chunk_recur`` takes CUDA tensors only, and checks shapes first."""
    x, la, b, c = _short_case("recur reject", "float32", 16, 16, 8)
    with pytest.raises(ValueError, match="device"):
        SC.ssd_chunk_recur(x, la, b, c)
    wide = torch.zeros(2, 16, 257)  # N past RECUR_MAX_N
    bad = [(x[:, :-1], la, b, c),  # S no longer matches log_a, b and c
           (x, la[:, :, :-1], b, c),  # heads
           (x, la, b, c[..., :-1]),  # N
           (x, la, wide, wide),
           (x[0], la, b, c)]  # rank
    for args in bad:
        with pytest.raises(ValueError, match="unsupported"):
            SC.ssd_chunk_recur(*args)


@pytest.mark.parametrize("L,N,route", [
    (1, 128, "recur"), (1, 17, "recur"), (1, 256, "recur"), (1, 257, "pair"), (2, 128, "pair"),
    (16, 64, "pair"), (128, 128, "pair")])
def test_scan_route_by_sizes(L, N, route):
    """One-token chunks with N up to ssd_recur's register limit take
    ``ssd_recur``; every other shape the pair of launches."""
    assert SC.scan_route(L, N) == route


@pytest.mark.parametrize("batch,H,P,grid", [
    (1, 80, 64, (4, 80, 1)), (2, 3, 7, (1, 3, 2)), (1, 24, 128, (8, 24, 1))])
def test_recur_grid_fills_132_sms(batch, H, P, grid):
    """Blocks of 16 columns: 4 x 80 = 320 blocks at the serving shape, more
    than the 132 SMs (80 heads alone fill 80)."""
    assert SC.recur_grid(batch, H, P) == grid
    if (batch, H, P) == (1, 80, 64):
        assert grid[0] * grid[1] * grid[2] >= 132


@pytest.mark.parametrize("batch,chunks,H,P,L,cpb", [
    (1, 8, 80, 64, 128, 1), (2, 13, 7, 64, 128, 1), (1, 4, 3, 24, 64, 1),
    (1, 1000, 80, 64, 1, 500), (2, 350, 10, 24, 1, 50), (1, 3, 2, 16, 32, 1),
    (1, 16, 80, 64, 16, 8), (2, 50, 3, 7, 1, 3)])
def test_scan_chunks_per_block(batch, chunks, H, P, L, cpb):
    """``ssd_scan`` takes one chunk a block from 64 rows up (640 blocks at
    the serving shape); shorter chunks in as few segments as give each of
    132 SMs a block: 2 segments of 500 one-token chunks at 80 heads."""
    assert SC.scan_chunks(batch, chunks, H, P, L, 132) == cpb


@pytest.mark.parametrize("dtype,L,N,P,route", [
    (torch.bfloat16, 128, 128, 64, "wgmma"), (torch.bfloat16, 64, 64, 16, "wgmma"),
    (torch.bfloat16, 64, 128, 128, "wgmma"), (torch.bfloat16, 1, 128, 64, "short"),
    (torch.bfloat16, 16, 16, 16, "short"), (torch.bfloat16, 128, 256, 64, "cells"),
    (torch.bfloat16, 128, 128, 136, "cells"), (torch.bfloat16, 128, 128, 60, "cells"),
    (torch.float32, 128, 128, 64, "cells"), (torch.float32, 1, 128, 64, "short"),
    (torch.float32, 16, 17, 7, "short"), (torch.float32, 2, 128, 64, "short"),
    (torch.float32, 17, 128, 64, "cells"), (torch.bfloat16, 17, 128, 64, "cells"),
    (torch.bfloat16, 32, 16, 16, "cells"), (torch.float32, 32, 128, 64, "cells"),
    (torch.float32, 64, 64, 64, "cells")])
def test_ssd_route_by_type_and_sizes(dtype, L, N, P, route):
    assert SC.ssd_route(dtype, L, N, P) == route


def test_ssd_route_rejects_other_types():
    with pytest.raises(TypeError):
        SC.ssd_route(torch.float16, 128, 128, 64)


@pytest.mark.parametrize("batch,chunks,H,G", [
    (1, 8, 80, 5), (2, 13, 7, 2), (1, 1, 80, 1), (64, 8, 80, 80), (1, 2, 3, 1)])
def test_heads_per_block_fills_132_sms(batch, chunks, H, G):
    """One block per SM where the heads allow it: 8 chunks x 16 groups of 5
    heads at the serving shape; the last group may be smaller."""
    assert SC.heads_per_block(batch, chunks, H, 132) == G


@pytest.mark.parametrize("batch,chunks,H,L,N,P,G", [
    (1, 1000, 80, 1, 128, 64, 27), (2, 350, 10, 1, 64, 24, 3), (64, 1000, 80, 1, 128, 64, 80),
    (1, 64, 80, 16, 384, 64, 1), (1, 64, 80, 16, 128, 64, 3), (1, 16, 7, 1, 17, 7, 1)])
def test_short_heads_leave_16_blocks_an_sm_within_48kb(batch, chunks, H, L, N, P, G):
    """At the one-token-chunk serving shape 1,000 chunks x 3 groups of 27
    heads (the last of 26); at L 16 and N 384 one head's staging already
    passes 48 KB, so a block takes one head."""
    assert SC.short_heads(batch, chunks, H, L, N, P, 132) == G


# ------------------------------------------------------------------- model ----
def test_param_tree_and_count_match_reference():
    cfg = get_config("mamba2_2p7b")
    spec = model_spec(cfg)
    assert set(spec["groups"]) == {"p0_ssd"}
    assert spec["groups"]["p0_ssd"]["ssd"]["in_proj"].shape == (64, 2560, 10576)
    assert spec["embed"]["head"].shape == (2560, 50280)
    assert param_count(spec) == 2_831_296_000
    assert cfg.param_count() == 2_830_704_640  # the config's own estimate
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        block_spec("rglru", get_smoke_config("recurrentgemma_9b"), SINGLE)
    with pytest.raises(NotImplementedError, match="ROADMAP A6.2"):
        block_spec("attn", get_smoke_config("qwen3_moe_30b_a3b"), SINGLE)


def _prefill_and_decode(dtype, S=40):
    cfg = dataclasses.replace(j_smoke("mamba2_2p7b"), dtype=dtype)
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    tcfg = dataclasses.replace(get_smoke_config("mamba2_2p7b"), dtype=dtype)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    prompt = _rng("prompt", dtype, S).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    with jops.local_backend("interpret"):
        jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(), capacity=64)
        jl, _ = jpre(jparams, jnp.asarray(prompt))
        jtok = np.asarray(j_generate(cfg, jparams, jpre, jdec, jnp.asarray(prompt), 8))
    tpre, tdec, _ = make_serve_fns(tcfg, SINGLE, capacity=64)
    tl, _ = tpre(model, torch.from_numpy(prompt).long())
    ttok = greedy_generate(tcfg, model, tpre, tdec, torch.from_numpy(prompt).long(), 8)
    return np.asarray(jl.astype(jnp.float32)), tl.float().numpy(), jtok, ttok.numpy()


@pytest.mark.parametrize("S", [32, 40])
def test_smoke_mamba2_float32_prefill_and_greedy_decode(S):
    """float32: last-token logits within 1e-5 of the largest |logit|, and 8
    greedy tokens equal.  S = 32 is one chunk; S = 40 takes the one-token-
    chunk rule."""
    jl, tl, jtok, ttok = _prefill_and_decode("float32", S)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    np.testing.assert_array_equal(ttok, jtok)


def test_smoke_mamba2_bfloat16_prefill():
    """bfloat16: logits within 2 bf16 ulps (2^-6) of the largest |logit|."""
    jl, tl, _, _ = _prefill_and_decode("bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2.0**-6 * np.abs(jl).max())
