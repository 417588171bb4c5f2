"""The gradient of the port's Mamba-2 SSD against the JAX package's, on the CPU.

``ssd_chunk_scan_bwd_plain`` (the backward written out in torch ops, which
the card's backward kernels are held against in chip_smoke.py) is held
against float64 autograd of ``ssd_chunk_scan_plain`` and against
``jax.vjp`` of the reference's ``ops.ssd_scan`` under ``local_backend("xla")``
(``ref.ssd_xla_chunked``, the function the reference trains through), one
sequence at a time as the reference vmaps it: several chunks, one-token
chunks (the reference's chunk rule for a length that is no multiple of the
chunk), one chunk shorter than 128, N 17 with P 7, and the final state's
cotangent given and absent.  The counted route (``kernels.ops._CountedSSD``)
gives autograd's gradient bit for bit and charges the three backward
kernels, on the CPU and on ``meta``.

Tolerances, relative to each gradient's largest |value|: float32 against
float64, 1e-5 (float32 sums over at most S terms); float32 against the
reference, 1e-5 (both float32, sums in another order).  bf16 inputs: dx, db
and dc are float32 sums rounded once to bf16 on both sides, so they may
differ by one bf16 ulp of a value where the float32 sums straddle a rounding
boundary: two bf16 ulps (2^-6) of the largest |value|; dlog_a is float32 on
both sides, from the same bf16 inputs: 1e-5.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_chunk as SC
from repro_torch.launch import roofline as rl

# (batch, S, H, P, N, chunk, dh given): three chunks of 32; the same without
# a final-state cotangent; one-token chunks at S 40 (no multiple of 32); one
# chunk of 96; N 17 with P 7 over four chunks of 16
SHAPES = [(2, 96, 3, 8, 16, 32, True), (2, 96, 3, 8, 16, 32, False),
          (1, 40, 2, 8, 16, 1, True), (2, 96, 2, 8, 16, 96, False),
          (1, 64, 3, 7, 17, 16, True)]
IDS = ["chunks", "no-dh", "L1", "one-chunk", "N17-P7"]
BF16_TOL = 2.0 ** -6
F32_TOL = 1e-5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _inputs(rng, bt, S, H, Pd, N, with_dh):
    """x, log_a, b, c, dy, dh in numpy float32.  The log decays lie in
    (-0.1, -0.001), so a chunk of 32 keeps about 0.2 of its inbound state
    and the gradient carried between chunks (D_k g_k) counts."""
    return (rng.normal(0, 1, (bt, S, H, Pd)).astype(np.float32),
            -rng.uniform(1e-3, 0.1, (bt, S, H)).astype(np.float32),
            rng.normal(0, 0.3, (bt, S, N)).astype(np.float32),
            rng.normal(0, 0.3, (bt, S, N)).astype(np.float32),
            rng.normal(0, 1, (bt, S, H, Pd)).astype(np.float32),
            rng.normal(0, 1, (bt, H, N, Pd)).astype(np.float32) if with_dh else None)


def _close(got, want, rel, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=what)


def _autograd(x, la, b, c, L, dy, dh, dtype):
    """Autograd of ``ssd_chunk_scan_plain`` at ``dtype``."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (x, la, b, c)]
    y, h = SC.ssd_chunk_scan_plain(*leaves, L)
    outs, cot = [y], [torch.from_numpy(dy).to(dtype)]
    if dh is not None:
        outs.append(h)
        cot.append(torch.from_numpy(dh).to(dtype))
    return torch.autograd.grad(outs, leaves, cot)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_plain_vs_float64_autograd(shape):
    bt, S, H, Pd, N, L, with_dh = shape
    x, la, b, c, dy, dh = _inputs(_rng("f64", shape), bt, S, H, Pd, N, with_dh)
    want = _autograd(x, la, b, c, L, dy, dh, torch.float64)
    got = SC.ssd_chunk_scan_bwd_plain(*(torch.from_numpy(a) for a in (x, la, b, c)), L,
                                      torch.from_numpy(dy),
                                      None if dh is None else torch.from_numpy(dh))
    for name, g, w in zip(("dx", "dlog_a", "db", "dc"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g.numpy(), w.numpy(), F32_TOL, name)
    # in float64 it is the same function to float64 rounding
    got64 = SC.ssd_chunk_scan_bwd_plain(*(torch.from_numpy(a).double() for a in (x, la, b, c)),
                                        L, torch.from_numpy(dy).double(),
                                        None if dh is None else torch.from_numpy(dh).double())
    for name, g, w in zip(("dx", "dlog_a", "db", "dc"), got64, want):
        _close(g.numpy(), w.numpy(), 1e-12, f"{name} float64")


def _reference_vjp(x, la, b, c, L, dy, dh, dtype):
    """``jax.vjp`` of the reference's ``ops.ssd_scan`` (xla), per sequence."""
    outs = []
    for s in range(x.shape[0]):
        args = (jnp.asarray(x[s], dtype), jnp.asarray(la[s]), jnp.asarray(b[s], dtype),
                jnp.asarray(c[s], dtype))
        with jops.local_backend("xla"):
            (y, h), vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=L), *args)
            cot_h = jnp.zeros_like(h) if dh is None else jnp.asarray(dh[s])
            outs.append(vjp((jnp.asarray(dy[s], dtype), cot_h)))
    return [np.stack([np.asarray(o[i], np.float32) for o in outs]) for i in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_plain_vs_reference_vjp(shape, dtype):
    bt, S, H, Pd, N, L, with_dh = shape
    x, la, b, c, dy, dh = _inputs(_rng("vjp", shape, dtype), bt, S, H, Pd, N, with_dh)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _reference_vjp(x, la, b, c, L, dy, dh, jdt)
    ins = [torch.from_numpy(a).to(tdt) for a in (x, la, b, c)]
    ins[1] = torch.from_numpy(la)
    got = SC.ssd_chunk_scan_bwd_plain(*ins, L, torch.from_numpy(dy).to(tdt),
                                      None if dh is None else torch.from_numpy(dh))
    for name, g, w, t in zip(("dx", "dlog_a", "db", "dc"), got, want,
                             (tdt, torch.float32, tdt, tdt)):
        assert g.dtype == t and tuple(g.shape) == w.shape, name
        rel = F32_TOL if t == torch.float32 else BF16_TOL
        _close(g.float().numpy(), w, rel, f"{name} {dtype}")


@pytest.mark.parametrize("shape", SHAPES[:3], ids=IDS[:3])
def test_counted_route_gives_autograd_and_charges_the_kernels(shape):
    """Under ``roofline.count()`` the plain route's gradient is autograd's
    bit for bit, charged as the card's three backward launches and counted
    the same on ``meta``."""
    bt, S, H, Pd, N, L, with_dh = shape
    x, la, b, c, dy, dh = _inputs(_rng("counted", shape), bt, S, H, Pd, N, with_dh)
    want = _autograd(x, la, b, c, L, dy, dh, torch.float32)
    counts = []
    for device in ("cpu", "meta"):
        leaves = [torch.from_numpy(a).to(device).requires_grad_(True) for a in (x, la, b, c)]
        cot = [torch.from_numpy(a).to(device) for a in (dy, dh) if a is not None]
        with tops.local_backend("torch"), rl.count() as counter:
            y, h = tops.ssd_scan(*leaves, chunk=L)
            got = torch.autograd.grad([y, h][:len(cot)], leaves, cot)
        counts.append((counter.cost.flops, counter.cost.bytes, counter.charged))
        if device == "cpu":
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert counts[0] == counts[1]
    route = {"recur": {"ssd_chunk_scan_recur": 1},
             "pair": {"ssd_chunk_scan": 1, "ssd_chunk_scan_inter": 1}}[SC.scan_route(L, N)]
    assert counts[0][2] == {**route, **{k: 1 for k in SC.BWD_KERNELS}}
    work = rl.ssd_bwd_work(bt, S, H, Pd, N, L, 4, with_dh)
    assert set(work) == set(SC.BWD_KERNELS)
    assert all(nb > 0 and fl > 0 for nb, fl in work.values())


_STATES = SC.ssd_bwd_states_plain


def _states_without_carry(x, log_a, b, c, chunk, dy, dh=None):
    """``ssd_bwd_states_plain`` with the carry D_k g_k dropped from the
    reverse walk (g_k = Q_{k+1}): the faulty backward of the control."""
    hin, g = _STATES(x, log_a, b, c, chunk, dy, dh)
    bt, S, H, Pd = x.shape
    nc, N = S // chunk, b.shape[-1]
    e = log_a.to(hin.dtype).reshape(bt, nc, chunk, H).cumsum(2).exp()
    ce = c.to(hin.dtype).reshape(bt, nc, chunk, 1, N) * e[..., None]
    q = torch.einsum("bnlhk,bnlhp->bnhkp", ce, dy.to(hin.dtype).reshape(bt, nc, chunk, H, Pd))
    return hin, torch.cat([q[:, 1:], g[:, -1:]], 1)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]], ids=["chunks", "L1"])
def test_states_and_the_faulty_control(shape, monkeypatch):
    """``ssd_bwd_states_plain``'s last h_in leads to the forward's final
    state (D h_in + S of the last chunk is the plain forward's h_final) and
    its last g is dh; the control that drops the carry D_k g_k lands far
    over the float32 limit."""
    bt, S, H, Pd, N, L, with_dh = shape
    x, la, b, c, dy, dh = _inputs(_rng("states", shape), bt, S, H, Pd, N, with_dh)
    t = [torch.from_numpy(a) for a in (x, la, b, c, dy)]
    hin, g = SC.ssd_bwd_states_plain(*t[:4], L, t[4], torch.from_numpy(dh))
    y_intra, state = SC.ssd_chunk_intra_plain(*t[:4], L)
    _, h_final = SC.ssd_chunk_inter_plain(y_intra, state, t[1], t[3])
    nc = S // L
    want = SC.chunk_decays(t[1], nc)[:, -1, -1, :, None, None] * hin[:, -1] + state[:, -1]
    _close(want.numpy(), h_final.numpy(), F32_TOL, "h_in of the last chunk")
    assert torch.equal(g[:, -1], torch.from_numpy(dh))
    good = SC.ssd_chunk_scan_bwd_plain(*t[:4], L, t[4], torch.from_numpy(dh))
    monkeypatch.setattr(SC, "ssd_bwd_states_plain", _states_without_carry)
    bad = SC.ssd_chunk_scan_bwd_plain(*t[:4], L, t[4], torch.from_numpy(dh))
    worst = max(float((p - q).abs().max() / q.abs().max()) for p, q in zip(bad, good))
    assert worst > 100 * F32_TOL


def test_bwd_work_at_the_training_shape():
    """The formula at mamba2_2p7b's training launch (1 x 4,096 x 80 x 64, N
    128, chunk 128, bf16), pinned: phase 5 of chip_smoke.py reads it."""
    work = rl.ssd_bwd_work(1, 4096, 80, 64, 128, 128, 2, False)
    assert work == {"ssd_chunk_scan_bwd_state": (255_066_112, 10_483_138_560),
                    "ssd_chunk_scan_bwd_chunk": (633_864_192, 32_911_982_592),
                    "ssd_chunk_scan_bwd_sum": (337_641_472, 83_886_080)}


def test_bwd_total_at_the_training_shape():
    """The whole backward's work at the same launch, pinned: its inputs and
    outputs alone (no scratch), and the three launches' flops; phase 5 of
    chip_smoke.py prints its bound beside the kernels'."""
    nbytes, flops = rl.ssd_bwd_total(1, 4096, 80, 64, 128, 128, 2, False)
    work = rl.ssd_bwd_work(1, 4096, 80, 64, 128, 128, 2, False)
    assert (nbytes, flops) == (132_644_864, 43_479_007_232)
    assert flops == sum(fl for _, fl in work.values())
    assert nbytes < min(nb for nb, _ in work.values())
    with_dh = rl.ssd_bwd_total(1, 4096, 80, 64, 128, 128, 2, True)
    assert with_dh[0] - nbytes == 4 * 80 * 128 * 64


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """The CUDA wrapper raises, with the shape in the message, on chunks past
    128, N past 256, P past 128 and tensors on the CPU; it never falls back
    to the plain version."""
    def args(bt=1, S=256, H=2, Pd=8, N=16, dev="cpu"):
        return (torch.zeros((bt, S, H, Pd), device=dev), torch.zeros((bt, S, H), device=dev),
                torch.zeros((bt, S, N), device=dev), torch.zeros((bt, S, N), device=dev))

    for kw, L in ((dict(), 256), (dict(N=257), 128), (dict(Pd=129), 128)):
        a = args(**kw)
        with pytest.raises(ValueError, match=r"ssd_chunk_scan_bwd: unsupported shapes x \("):
            SC.ssd_chunk_scan_bwd(*a, L, torch.zeros_like(a[0]))
    a = args()
    with pytest.raises(ValueError, match="unsupported device cpu"):
        SC.ssd_chunk_scan_bwd(*a, 128, torch.zeros_like(a[0]))
    a = args(dev="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        SC.ssd_chunk_scan_bwd(*a, 128, torch.zeros_like(a[0]))


# (dtype, L, N, P) → the backward's route: chip_smoke.py's SSD_BWD_SHAPES
# (the training launch with and without dh, float32, L 64, the chunk-1 rule,
# one chunk of 96, N 17 with P 7 at chunks of 16 and 1, N 256, N 64 with P
# 128, P 72 at chunks of 64), then the route's edges (P 72 at chunks of 128,
# P 7, P 136, N 96)
ROUTES = [(torch.bfloat16, 128, 128, 64, "wgmma"), (torch.float32, 128, 128, 64, "cells"),
          (torch.bfloat16, 64, 128, 64, "wgmma"), (torch.bfloat16, 1, 128, 64, "cells"),
          (torch.bfloat16, 96, 128, 64, "cells"), (torch.float32, 16, 17, 7, "cells"),
          (torch.float32, 1, 17, 7, "cells"), (torch.bfloat16, 32, 256, 128, "cells"),
          (torch.bfloat16, 128, 64, 128, "wgmma"), (torch.bfloat16, 128, 128, 72, "wgmma"),
          (torch.bfloat16, 64, 128, 72, "wgmma"), (torch.bfloat16, 128, 128, 7, "cells"),
          (torch.bfloat16, 128, 128, 136, "cells"), (torch.bfloat16, 128, 96, 64, "cells")]


@pytest.mark.parametrize("dtype,L,N,Pd,route", ROUTES,
                         ids=[f"{str(r[0])[6:]}-L{r[1]}-N{r[2]}-P{r[3]}" for r in ROUTES])
def test_bwd_route(dtype, L, N, Pd, route):
    """The backward's state and chunk kernels follow the forward's rule:
    bf16 with L and N in {64, 128}, P <= 128 and P % 8 == 0 on the tensor
    cores, every other shape on the float32 FMA kernels."""
    assert SC.bwd_route(dtype, L, N, Pd) == route
    assert route == ("wgmma" if SC.ssd_route(dtype, L, N, Pd) == "wgmma" else "cells")


@pytest.mark.parametrize("dtype,L,N,Pd,route", ROUTES,
                         ids=[f"{str(r[0])[6:]}-L{r[1]}-N{r[2]}-P{r[3]}" for r in ROUTES])
def test_bwd_kernels_follow_the_route(dtype, L, N, Pd, route):
    """The names the backward's launches count and charge under are those
    of the route's own kernels, state, chunk and sum in ssd_bwd_work's
    order; float16, which no kernel takes, keeps the FMA kernels' names."""
    names = SC.bwd_kernels(dtype, L, N, Pd)
    assert names == (SC.BWD_KERNELS_WGMMA if route == "wgmma" else SC.BWD_KERNELS)
    assert names[2] == "ssd_chunk_scan_bwd_sum"
    assert [n.replace("_wgmma", "") for n in names] == list(rl.ssd_bwd_work(1, L, 1, Pd, N, L, 2))
    assert SC.bwd_kernels(torch.float16, L, N, Pd) == SC.BWD_KERNELS


def test_counted_route_charges_the_tensor_core_kernels_at_bf16():
    """On ``meta`` at a tensor-core shape (bf16, 1 x 256 x 2 x 64, N 128,
    chunk 128) the counted step charges the backward under the wgmma
    kernels' names, as the card launches them, each at ssd_bwd_work's
    figure for its part."""
    shapes = ((1, 256, 2, 64), (1, 256, 2), (1, 256, 128), (1, 256, 128))
    leaves = [torch.empty(sh, dtype=torch.float32 if i == 1 else torch.bfloat16,
                          device="meta").requires_grad_(True) for i, sh in enumerate(shapes)]
    with tops.local_backend("torch"), rl.count() as counter:
        y, _ = tops.ssd_scan(*leaves, chunk=128)
        torch.autograd.grad([y], leaves, [torch.empty_like(y)])
    route = {"recur": {"ssd_chunk_scan_recur": 1},
             "pair": {"ssd_chunk_scan": 1, "ssd_chunk_scan_inter": 1}}[SC.scan_route(128, 128)]
    assert counter.charged == {**route, **{k: 1 for k in SC.BWD_KERNELS_WGMMA}}
    work = rl.ssd_bwd_work(1, 256, 2, 64, 128, 128, 2, False)
    for name, part in zip(SC.BWD_KERNELS_WGMMA, SC.BWD_KERNELS):
        assert counter.by_op[name] == [1, float(work[part][1]), float(work[part][0])]


def test_bwd_route_refuses_float16():
    with pytest.raises(TypeError, match="unsupported type torch.float16"):
        SC.bwd_route(torch.float16, 128, 128, 64)


def test_chunk_kernel_heads_fill_the_card_at_the_training_launch():
    """At mamba2_2p7b's training launch (1 x 4,096 x 80 heads, chunk 128) on
    132 SMs a block of ssd_bwd_chunk_wgmma walks 20 heads: 4 groups x 32
    chunks = 128 blocks, one an SM; one head fewer a block would need 160."""
    G = SC.heads_per_block(1, 32, 80, 132)
    blocks = -(-80 // G) * 32
    assert (G, blocks) == (20, 128)
    assert -(-80 // (G - 1)) * 32 > 132


def _args(dev, off=None, dtype=torch.bfloat16):
    """x, log_a, b, c, dy at a tensor-core shape (1 x 256 x 2 x 64, N 128),
    the one named ``off`` starting one element past a 16-byte boundary."""
    shapes = {"x": (1, 256, 2, 64), "b": (1, 256, 128), "c": (1, 256, 128), "dy": (1, 256, 2, 64)}
    out = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        flat = torch.zeros(n + 8, dtype=dtype, device=dev)
        out[name] = (flat[1:n + 1] if name == off else flat[:n]).view(shape)
    la = torch.zeros((1, 256, 2), device=dev)
    return out["x"], la, out["b"], out["c"], out["dy"]


@pytest.mark.parametrize("dev", ["cpu", "meta"])
@pytest.mark.parametrize("off", ["x", "b", "c", "dy"])
def test_wrapper_refuses_a_misaligned_tma_operand(off, dev):
    """On the tensor-core route the wrapper names an operand whose data is
    off a 16-byte boundary (TMA loads it) before anything else about it; an
    aligned set reaches the device check, and so does a misaligned float32
    set, whose route loads nothing by TMA."""
    x, la, b, c, dy = _args(dev, off)
    assert SC.bwd_route(x.dtype, 128, 128, 64) == "wgmma"
    with pytest.raises(ValueError, match=f"^{off}: its data must start on a 16-byte boundary"):
        SC.ssd_chunk_scan_bwd(x, la, b, c, 128, dy)
    with pytest.raises(ValueError, match=f"^{off}: its data must start"):
        SC.ssd_bwd_states(x, la, b, c, 128, dy)
    for args in (_args(dev), _args(dev, off, torch.float32)):
        with pytest.raises(ValueError, match=f"unsupported device {dev}"):
            SC.ssd_chunk_scan_bwd(*args[:4], 128, args[4])
