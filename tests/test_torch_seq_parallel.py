"""Sequence parallelism between blocks and the loss on the head's vocabulary
slices (``repro_torch.models.{tp,lm}``) on the CPU.

The reference shards its residual stream over the ``model`` axis along the
sequence whenever ``mesh is not None and S > 1 and S % tp == 0 and cache is
None`` (``repro.models.lm.forward``'s ``seq_sp``), and keeps its logits and
its loss in vocabulary slices; neither changes the answer.  The port's
tensor-parallel model does the same under ``lm.seq_parallel``, and every
value is that of the whole-row path, which the tests reach by
patching the predicate to ``False``.  The mesh is emulated as in
``test_torch_tensor_parallel.py`` (``cpu:i`` devices stand for distinct
cards).  Inputs come from seeds through numpy.

Held here, at the smoke configs (2 layers, sequences of 32 or less, tp 2
and 4):
- the two moves (``tp.all_gather_seq``, ``tp.reduce_scatter_seq``) against
  whole-tensor ops, their fixed backward (float32, shard order, rounded
  once), a repeat bit for bit, and their profiler ranges in a step;
- the predicate's cases, a VLM's patch embeddings counted in its length;
- the SP forward's logits bit for bit the whole-row path's for every block
  type: dense attention + MLP, an MoE, the SSD, RG-LRU + local attention, a
  VLM, four codebooks, a tied embedding with whole attention (smollm with
  3 q heads);
- ``lm.lm_loss_sliced`` against ``lm_loss`` on the joined logits (float32,
  1e-6 relative; gradients within 1e-6 of the largest): a vocabulary that
  needs padding at tp 2 and 4 and one that needs none, ``-100`` labels,
  codebooks whose columns straddle the shards;
- no op of a TP training step makes a tensor with a whole vocabulary axis
  (the no-mesh step, the control, does);
- ``launch.probe.collective_costs``' tensor-parallel kinds against the bytes
  a smoke step's moves carry, at tp 2 and 4, with and without SP, for a
  dense model, an MoE and ``mamba2_2p7b``, and a served forward and decode.
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SynthSpec, batch_at
from repro_torch.launch import probe
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ShardCtx, init_model, init_cache
from repro_torch.models import lm
from repro_torch.models import tp as TP
from repro_torch.train.trainstep import init_placed_state, value_and_grad

CARDS = [f"cpu:{i}" for i in range(4)]
LOSS_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): its
    steps are many small ops, and under parallel test workers more threads
    only oversubscribe the cores.  Every comparison here is within one
    process or within a tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _batch(cfg, seq=32, batch=2, i=0):
    return {k: torch.from_numpy(v) for k, v in batch_at(SynthSpec(
        vocab=cfg.vocab, seq_len=seq, batch=batch, n_codebooks=cfg.n_codebooks, seed=1), i).items()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# ------------------------------------------------------------------ moves --


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_moves_and_their_fixed_backward(n, dtype):
    """``all_gather_seq`` joins the slices on every shard, and its backward
    hands slice s the shards' gradients for its tokens added in shard order
    in float32, rounded once; ``reduce_scatter_seq`` gives slice s what
    ``reduce_sum`` gives its tokens, and its backward joins the slices'
    gradients on every part's device; both twice, bit for bit."""
    g = torch.Generator().manual_seed(n)

    def run():
        torch.manual_seed(0)
        x = torch.randn(2, 4 * n, 3, generator=torch.Generator().manual_seed(1)).to(dtype)
        parts = [p.clone().requires_grad_(True) for p in x.chunk(n, 1)]
        outs = TP.all_gather_seq(parts, CARDS[:n])
        assert all(torch.equal(o, x) for o in outs)
        gs = [torch.randn(x.shape, generator=torch.Generator().manual_seed(2 + s)).to(dtype)
              for s in range(n)]
        torch.autograd.backward(outs, gs)
        want = gs[0].float()
        for t in gs[1:]:
            want = want + t.float()
        want = want.to(dtype).chunk(n, 1)
        assert all(_bits(p.grad).equal(_bits(w)) for p, w in zip(parts, want))
        ps = [torch.randn(x.shape, generator=torch.Generator().manual_seed(9 + s)).to(dtype)
              .requires_grad_(True) for s in range(n)]
        sl = TP.reduce_scatter_seq(ps)
        whole = TP.reduce_sum([p.detach() for p in ps], "cpu")
        assert all(_bits(a).equal(_bits(b)) for a, b in zip(sl, whole.chunk(n, 1)))
        dy = [torch.randn(s.shape, generator=g).to(dtype) for s in sl]
        torch.autograd.backward(sl, dy)
        assert all(torch.equal(p.grad, torch.cat(dy, 1)) for p in ps)
        return [p.grad for p in parts] + [o for o in sl]

    a, b = run(), run()
    assert all(_bits(x).equal(_bits(y)) for x, y in zip(a, b))


def test_a_traced_tp_step_names_both_moves():
    """A TP training step under SP traces ``tp_seq_gather`` and
    ``tp_seq_scatter`` (each move's forward and its backward)."""
    from torch.profiler import profile

    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    mesh = make_mesh(1, 2, devices=CARDS[:2])
    run = RunConfig(model=cfg, shape=ShapeConfig("tiny", "train", 32, 2), tp=2)
    model, _ = init_placed_state(cfg, run, ShardCtx(tp=2), mesh)
    with profile() as prof:
        value_and_grad(model, cfg, _batch(cfg), ShardCtx(tp=2), True, mesh)
    names = {e.key for e in prof.key_averages()}
    assert {"tp_seq_gather", "tp_seq_scatter", "tp_broadcast", "tp_sum"} <= names


# -------------------------------------------------------------- predicate --


def test_the_predicate_is_the_references():
    """True exactly when the reference's ``seq_sp`` is, with tp > 1."""
    mesh = object()
    assert lm.seq_parallel(mesh, 32, 2, None) and lm.seq_parallel(mesh, 32, 4, None)
    assert not lm.seq_parallel(mesh, 30, 4, None)  # S % tp != 0
    assert not lm.seq_parallel(mesh, 32, 2, {})  # a cache (prefill, decode)
    assert not lm.seq_parallel(mesh, 32, 1, None)  # tp 1
    assert not lm.seq_parallel(mesh, 1, 1, None) and not lm.seq_parallel(None, 32, 2, None)


def _gathers(monkeypatch):
    calls = []
    fn = TP.all_gather_seq

    def counting(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(TP, "all_gather_seq", counting)
    return calls


@pytest.mark.parametrize("text,engaged", [(10, True), (12, False)])
def test_a_vlms_patch_embeddings_count_in_its_length(text, engaged, monkeypatch):
    """internvl2 with 6 patch embeddings over 4 shards: before 10 text
    tokens they make 16, which 4 divides (SP), though 10 it does not;
    before 12, 18, which it does not (the whole-row path)."""
    cfg = dataclasses.replace(get_smoke_config("internvl2_76b"), n_vis_tokens=6)
    mesh = make_mesh(1, 4, devices=CARDS)
    model = init_model(cfg, ShardCtx(tp=4), seed=0, mesh=mesh)
    calls = _gathers(monkeypatch)
    rng = _rng("vlm", text)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, text)))
    vis = torch.as_tensor(rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model)),
                          dtype=torch.float32)
    with torch.no_grad():
        out = lm.forward(model, cfg, tokens, ShardCtx(tp=4), mesh=mesh, vis_embeds=vis)[0]
    assert out.shape[1] == text and bool(calls) == engaged


def test_a_cache_keeps_the_whole_row_path(monkeypatch):
    """A prefill into a cache over the shards never cuts the sequence."""
    cfg = get_smoke_config("qwen3_8b")
    mesh = make_mesh(1, 2, devices=CARDS[:2])
    model = init_model(cfg, ShardCtx(tp=2), seed=0, mesh=mesh)
    calls = _gathers(monkeypatch)
    cache = init_cache(cfg, 2, 32, mesh=mesh)
    with torch.no_grad():
        lm.forward(model, cfg, torch.zeros(2, 16, dtype=torch.long), ShardCtx(tp=2), mesh=mesh,
                   cache=cache)
    assert not calls


# ---------------------------------------------------------------- forward --

FORWARD = ["qwen3_8b", "granite_moe_3b_a800m", "mamba2_2p7b", "recurrentgemma_9b",
           "internvl2_76b", "musicgen_large", "smollm_360m"]


@pytest.mark.parametrize("tp,dtype", [(2, "float32"), (4, "bfloat16")])
@pytest.mark.parametrize("arch", FORWARD)
def test_sp_forward_is_the_whole_row_path_bit_for_bit(arch, tp, dtype, monkeypatch):
    """The cache-free forward over ``make_mesh(1, tp)`` of distinct devices:
    under SP (the moves taken) the logits equal the whole-row path's bit
    for bit; granite expert-parallel; smollm with 3 q heads (its
    attention whole, joined on the first device; a tied embedding)."""
    kw = dict(n_q_heads=3, n_kv_heads=1) if arch == "smollm_360m" else {}
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    ctx = ShardCtx(tp=tp)
    mesh = make_mesh(1, tp, devices=CARDS[:tp])
    model = init_model(cfg, ctx, seed=0, mesh=mesh)
    rng = _rng("forward", arch, tp)
    shape = (2, cfg.n_codebooks, 24) if cfg.n_codebooks > 1 else (2, 24)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, shape))
    vis = (torch.as_tensor(rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model)),
                           dtype=torch.float32) if cfg.n_vis_tokens else None)
    use_ep = cfg.moe is not None
    calls = _gathers(monkeypatch)
    with torch.no_grad():
        sp = lm.forward(model, cfg, tokens, ctx, mesh=mesh, vis_embeds=vis, use_ep=use_ep)[0]
        assert calls
        monkeypatch.setattr(lm, "seq_parallel", lambda *a: False)
        whole = lm.forward(model, cfg, tokens, ctx, mesh=mesh, vis_embeds=vis, use_ep=use_ep)[0]
    assert sp.dtype == whole.dtype and _bits(sp).equal(_bits(whole))


# ------------------------------------------------------------------- loss --


@pytest.mark.parametrize("vocab,tp,K", [(120, 2, 1), (120, 4, 1), (128, 4, 1), (200, 2, 3),
                                        (100, 4, 4), (100, 4, 2)])
def test_sliced_loss_is_lm_loss_on_the_joined_logits(vocab, tp, K):
    """The loss on the shards' column slices against ``lm_loss`` on the
    logits they join into, and its gradient: the padded tail (120 and 200
    padded at tp 2 and 4; 128 not), ``-100`` labels, codebooks whose
    columns straddle the shards (3 over 2, 2 over 4)."""
    V = dataclasses.replace(get_smoke_config("qwen3_8b"), vocab=vocab).padded_vocab(tp)
    g = torch.Generator().manual_seed(vocab + tp + K)
    logits = (torch.randn(2, 16, K * V, generator=g) * 4).requires_grad_(True)
    labels = torch.randint(0, vocab, (2, 16) if K == 1 else (2, K, 16), generator=g)
    labels[0, ..., :3] = -100
    want = lm.lm_loss(logits if K == 1 else logits.reshape(2, 16, K, V), labels, vocab)
    (gw,) = torch.autograd.grad(want, logits)
    parts = [p.clone() for p in logits.detach().chunk(tp, -1)]
    for p in parts:
        p.requires_grad_(True)
    got = lm.lm_loss_sliced(parts, labels, vocab, K)
    grads = torch.autograd.grad(got, parts)
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=LOSS_REL)
    err = float((torch.cat(grads, -1) - gw).abs().max())
    assert err <= LOSS_REL * float(gw.abs().max())


class _Widest(TorchDispatchMode):
    """The largest size any op's output gives one dimension."""

    def __init__(self):
        super().__init__()
        self.widest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dim():
                self.widest = max(self.widest, max(t.shape))
        return out


@pytest.mark.parametrize("tp", [2, 4])
def test_no_op_of_a_tp_step_makes_the_whole_vocabulary(tp):
    """qwen3_8b with a vocabulary of 1,000 (wider than every other
    dimension): no op of the TP step (TP × FSDP over (2, tp)) makes a
    tensor that spans ``padded_vocab(tp) / tp`` columns more than once
    over; the no-mesh step, the control, makes the whole vocabulary."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32", vocab=1000)
    run = RunConfig(model=cfg, shape=ShapeConfig("tiny", "train", 32, 4), dp=2, tp=tp,
                    remat="full")
    mesh = make_mesh(2, tp, devices=["cpu"] * (2 * tp))
    model, _ = init_placed_state(cfg, run, ShardCtx(tp=tp, dp=2), mesh)
    with _Widest() as seen:
        value_and_grad(model, cfg, _batch(cfg, batch=4), ShardCtx(tp=tp), True, mesh)
    assert seen.widest == cfg.padded_vocab(tp) // tp
    whole = init_model(cfg, ShardCtx(tp=tp), seed=0, device="cpu", trainable=True)
    with _Widest() as control:
        value_and_grad(whole, cfg, _batch(cfg, batch=4), ShardCtx(tp=tp), True)
    assert control.widest == cfg.padded_vocab(tp)


# ------------------------------------------------------------ collectives --

MOVES = {TP._Broadcast: "tp-broadcast", TP._ReduceSum: "tp-sum", TP._Join: "tp-join",
         TP._Scatter: "tp-scatter", TP._Send: "tp-scatter", TP._AllGatherSeq: "sp-gather",
         TP._ReduceScatterSeq: "sp-scatter"}


def _nbytes(t):
    return t.numel() * t.element_size()


def _spy_moves(monkeypatch):
    """Each move's forward and backward counted into its kind: the bytes
    that leave shard 0's card for another shard's or come to it, and those
    between two other shards (a part's position is its shard: shard 0 lies
    on the row's first card, where a broadcast starts and a sum, a join
    ends)."""
    moved = {k: 0 for k in MOVES.values()}

    def wrap(cls, kind):
        fwd, bwd = cls.forward, cls.backward

        def forward(ctx, *args):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            devices = next((a for a in args if isinstance(a, tuple)), None)
            if cls in (TP._Broadcast,):
                moved[kind] += _nbytes(tensors[0]) * (len(devices) - 1)
            elif cls is TP._AllGatherSeq:
                moved[kind] += sum(map(_nbytes, tensors)) * (len(devices) - 1)
            elif cls is TP._ReduceScatterSeq:
                moved[kind] += _nbytes(tensors[0]) * (len(tensors) - 1)
            elif cls is TP._Send:  # every tensor but shard 0's (k of them)
                k = next(a for a in args if isinstance(a, int))
                moved[kind] += sum(map(_nbytes, tensors[k:]))
            else:  # sum, join, scatter: every part but shard 0's
                moved[kind] += sum(map(_nbytes, tensors[1:]))
            return fwd(ctx, *args)

        def backward(ctx, *grads):
            if cls in (TP._Broadcast, TP._Scatter):
                moved[kind] += sum(map(_nbytes, grads[1:]))
            elif cls is TP._AllGatherSeq:
                moved[kind] += _nbytes(grads[0]) * (len(grads) - 1)
            elif cls is TP._ReduceScatterSeq:
                moved[kind] += sum(map(_nbytes, grads)) * (len(grads) - 1)
            elif cls is TP._ReduceSum:
                moved[kind] += _nbytes(grads[0]) * (len(ctx.homes) - 1)
            else:  # join
                moved[kind] += _nbytes(grads[0]) * (len(ctx.homes) - 1) // len(ctx.homes)
            return bwd(ctx, *grads)

        monkeypatch.setattr(cls, "forward", staticmethod(forward))
        monkeypatch.setattr(cls, "backward", staticmethod(backward))

    for cls, kind in MOVES.items():
        wrap(cls, kind)
    return moved


def _want(cfg, run, tp, kind):
    got = probe.collective_costs(cfg, run, ShardCtx(tp=tp), kind)
    want = {k: got.get(k, 0) for k in MOVES.values()}
    want["tp-broadcast"] += got.get("ep-dispatch", 0)  # the MoE's tokens and router
    return want


@pytest.mark.parametrize("sp", [True, False])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_3b_a800m", "mamba2_2p7b"])
def test_tp_collectives_equal_what_the_step_moves(arch, tp, sp, monkeypatch):
    """A TP training step (remat full: every forward move twice) over
    ``make_mesh(1, tp)``: the bytes each kind of move carries, counted on
    the moves, equal ``collective_costs``' tensor-parallel kinds (an MoE's
    broadcasts also carry its ``ep-dispatch``); without SP (the predicate
    patched, for the step and the reckoning alike) no ``sp-*`` bytes."""
    if not sp:
        monkeypatch.setattr(lm, "seq_parallel", lambda *a: False)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("tiny", "train", 32, 2), tp=tp, remat="full")
    mesh = make_mesh(1, tp, devices=CARDS[:tp])
    model, _ = init_placed_state(cfg, run, ShardCtx(tp=tp), mesh)
    moved = _spy_moves(monkeypatch)
    value_and_grad(model, cfg, _batch(cfg), ShardCtx(tp=tp), True, mesh)
    want = _want(cfg, run, tp, "train")
    assert moved == want
    assert (moved["sp-gather"] > 0) == sp


SERVED = {"qwen3_8b": {}, "qwen3_8b kv4": {"n_kv_heads": 4}, "h2o_danube_3_4b kv4":
          {"n_kv_heads": 4}, "mamba2_2p7b": {}, "recurrentgemma_9b": {}}


@pytest.mark.parametrize("kind", ["prefill", "cached prefill", "decode"])
@pytest.mark.parametrize("arch", list(SERVED))
def test_tp_collectives_equal_what_serving_moves(arch, kind, monkeypatch):
    """A model served over ``make_mesh(1, 4)``: a cache-free forward of 32
    tokens (SP; the logits joined), a prefill of 12 tokens into a cache of
    32 slots and a decode step into it, each cache placed as
    ``lm.init_cache(mesh=...)`` places it: the bytes each kind of move
    carries equal ``probe.tp_moves``' (through ``collective_costs`` where
    a dry-run cell has the pass).  The configs take every placement: KV by
    slots (``qwen3_8b``'s one kv head), by kv heads (four kv heads: the
    contiguous cache and ``h2o_danube_3_4b``'s ring), the SSD state by heads,
    RG-LRU's by width beside a ring kept whole."""
    cfg = dataclasses.replace(get_smoke_config(arch.split()[0]), **SERVED[arch])
    mesh = make_mesh(1, 4, devices=CARDS)
    model = init_model(cfg, ShardCtx(tp=4), seed=0, mesh=mesh)
    S = {"prefill": 32, "cached prefill": 12, "decode": 1}[kind]
    cache = None if kind == "prefill" else init_cache(cfg, 2, 32, mesh=mesh)
    tokens = torch.zeros(2, S, dtype=torch.int32)
    moved = _spy_moves(monkeypatch)
    with torch.no_grad():
        lm.forward(model, cfg, tokens, ShardCtx(tp=4), mesh=mesh, cache=cache,
                   start_pos=None if kind != "decode" else torch.tensor(5))
    if kind == "cached prefill":
        want = {k: 0 for k in MOVES.values()}
        want.update(probe.tp_moves(cfg, "prefill", 2, S, 4, capacity=32)[0])
    else:
        run = RunConfig(model=cfg, shape=ShapeConfig("tiny", kind, 32, 2), tp=4)
        want = _want(cfg, run, 4, kind)
    assert moved == want
