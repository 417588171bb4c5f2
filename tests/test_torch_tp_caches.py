"""The serving caches placed over a data row's model shards, on the CPU,
against the JAX package.

The reference compiles its decode with each cache placed by
``make_cache_specs``: a KV cache by kv heads where they divide ``tp``, else by
slots (split-S decode); the SSD state by heads; the RG-LRU state and every
conv tail by width.  ``lm.init_cache(mesh=...)`` places the port's live
caches the same way, and each block reads and writes its part where it
lies; the one exception is the window ring whose kv heads do not divide
``tp``, which stays whole on the row's first device
(``launch.specs.live_cache_specs`` names it).  The mesh is emulated by
``cpu:i`` devices (distinct cards: ``.to("cpu:1")`` copies).  Inputs come
from seeds through numpy.

Held here, at the smoke configs (2 layers; ``qwen3_8b`` and
``h2o_danube_3_4b`` with four kv heads, so that the head placement runs),
float32, over ``make_mesh(1, tp)`` at tp 2 and 4:
- the placement each case takes; after the prefill and after each decode
  step every cache tensor's device and each shard's bytes against the
  reckoning from ``make_cache_specs``, the ring exception by name;
- a prefill of 12 tokens and 4 greedy decode steps against the reference's
  ``make_serve_fns`` with no mesh, each step's logits within 1e-5 of the
  largest |logit|; a control with one shard's heads zeroed in the cache
  goes over that limit;
- the head-placed decode of one attention block bit for bit the decode on
  the same cache split by slots (``_split_s_decode``), float32 and bf16,
  with the weights in head slices and whole;
- no join of q, k or v and no scatter of the output in a head-placed
  prefill or decode (the moves spied);
- a served prefix cache's size over ``make_mesh(1, 4)`` (``CacheResult``,
  what the engine's eviction charges) equal to the whole cache's bytes;
- the placed caches' logits against the same mesh's with the caches whole
  on the first device: bit for bit, the SSD's and RG-LRU's float32 decode
  within 1e-6 relative (the CPU's vectorised kernels round a slice's tail
  otherwise);
- ``tp.send``, a shard's several inputs in one copy, and a write into a
  cache by slots that sends each shard only the tokens its slots take.
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
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tatt
from repro_torch.models import lm, params_from_numpy
from repro_torch.models import tp as TP
from repro_torch.models.base import ShardCtx
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssd import SSDCache
from repro_torch.serve import make_serve_fns
from repro_torch.serve.session import CacheResult

CARDS = [f"cpu:{i}" for i in range(4)]
F32_TOL = 1e-5
CAPACITY = 32
PROMPT = 12
STEPS = 4
# name: (arch, config changes, each block type's placement over the shards)
CASES = {
    "qwen3_8b kv4": ("qwen3_8b", {"n_kv_heads": 4}, {"attn": "heads"}),
    "h2o_danube_3_4b kv4 ring": ("h2o_danube_3_4b", {"n_kv_heads": 4}, {"attn": "heads"}),
    "qwen3_8b": ("qwen3_8b", {}, {"attn": "slots"}),
    "mamba2_2p7b": ("mamba2_2p7b", {}, {"ssd": "split"}),
    "recurrentgemma_9b": ("recurrentgemma_9b", {}, {"rglru": "split", "local_attn": "whole"}),
}
# the one exception to make_cache_specs: a window ring whose kv heads do not divide tp
RING_EXCEPTION = {"recurrentgemma_9b": [("groups", "p2_local_attn", "k"),
                                        ("groups", "p2_local_attn", "v")]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): many
    small ops, and under parallel test workers more threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cfgs(case, dtype="float32"):
    arch, change, _ = CASES[case]
    return (dataclasses.replace(j_smoke(arch), dtype=dtype, **change),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **change))


def _served(case, tp):
    """(reference config, port config, reference params, the port's model in
    slices over ``make_mesh(1, tp)`` of distinct devices, the mesh)."""
    cfg, tcfg = _cfgs(case)
    jparams = j_init_model(cfg, JShardCtx(tp=tp), seed=0)
    mesh = make_mesh(1, tp, devices=CARDS[:tp])
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, ctx=ShardCtx(tp=tp),
                              mesh=mesh)
    return cfg, tcfg, jparams, model, mesh


def _blocks(cache):
    """[(block type, its cache)] of a cache tree (a stacked group's once)."""
    return [(key.split("_", 1)[1], c) for part in ("groups", "extra")
            for key, c in cache.get(part, {}).items()]


def _layout(c) -> str:
    if isinstance(c, tatt.ShardedKVCache):
        return {1: "heads", 2: "slots"}[c.dim]
    if isinstance(c, (SSDCache, RGLRUCache)):
        return "split" if isinstance(c.h, tuple) and isinstance(c.conv, tuple) else "whole"
    return "whole"


def _home(device) -> torch.device:
    """The device a tensor made on ``device`` reports (a CPU tensor's has no
    index)."""
    return torch.empty(0, device=device).device


def _check_placement(case, tcfg, cache, mesh, tp, batch=2):
    """Each block's cache in its case's placement, every slice on its
    shard's device and every whole tensor (``pos`` among them) on the row's
    first, each shard's bytes the reckoning from ``make_cache_specs``."""
    want = CASES[case][2]
    for btype, c in _blocks(cache):
        assert _layout(c) == want[btype], (case, btype)
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            if isinstance(v, tuple):
                assert len(v) == tp and [t.device for t in v] == [
                    _home(mesh.device(0, s)) for s in range(tp)], (case, btype, f.name)
            elif isinstance(v, torch.Tensor):
                assert v.device == _home(mesh.first), (case, btype, f.name)
    assert lm.cache_shard_bytes(cache, tp) == specs.cache_shard_bytes(tcfg, tp, batch, CAPACITY)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_placed_caches_decode_as_the_reference_without_a_mesh(case, tp):
    """A prefill of 12 tokens and 4 greedy decode steps through
    ``make_serve_fns`` over ``make_mesh(1, tp)`` against the reference's
    with no mesh, fed the reference's tokens: each step's logits within
    1e-5 of the largest |logit|, and the caches in their placement with
    each shard's bytes the reckoning after every step."""
    cfg, tcfg, jparams, model, mesh = _served(case, tp)
    prompt = _rng("prompt", case).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(tp=tp), capacity=CAPACITY)
    tpre, tdec, _ = make_serve_fns(tcfg, ShardCtx(tp=tp), mesh=mesh, capacity=CAPACITY)
    with jops.local_backend("xla"):
        jl, jc = jpre(jparams, jnp.asarray(prompt))
    tl, tc = tpre(model, torch.from_numpy(prompt))
    for step in range(STEPS + 1):
        _check_placement(case, tcfg, tc, mesh, tp)
        jl32 = np.asarray(jl.astype(jnp.float32))
        np.testing.assert_allclose(tl.numpy(), jl32, rtol=0, atol=F32_TOL * np.abs(jl32).max(),
                                   err_msg=f"{case} step {step}")
        if step == STEPS:
            break
        nxt = np.asarray(jnp.argmax(jl[..., :cfg.vocab], -1)).astype(np.int32)[:, None]
        pos = PROMPT + step
        with jops.local_backend("xla"):
            jl, jc = jdec(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(model, tc, torch.from_numpy(nxt), torch.tensor(pos, dtype=torch.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_the_ring_exception_is_the_only_departure_from_make_cache_specs(case):
    """``live_cache_specs`` departs from ``make_cache_specs`` only at a window
    ring whose kv heads do not divide ``tp`` (RecurrentGemma's local
    attention, one kv head), named leaf by leaf, at the smoke size and at
    the published one; ``make_cache_specs`` splits that ring's slots."""
    arch = CASES[case][0]
    for cfg in (_cfgs(case)[1], get_config(arch)):
        for tp in (2, 4):
            cache = lm.init_cache(cfg, 2, 4096, device="meta")
            live, whole = specs.live_cache_specs(cfg, ShardCtx(tp=tp), cache)
            assert whole == RING_EXCEPTION.get(case, []), (case, tp)
            ref = specs.make_cache_specs(cfg, ShardCtx(tp=tp), cache)
            differ = [p for (p, a), (_, b) in zip(specs.cache_leaves(live),
                                                  specs.cache_leaves(ref)) if a != b]
            assert differ == whole
            for path in whole:
                assert ref[path[0]][path[1]].k[3] == "model"  # the ring's slots


@pytest.mark.parametrize("tp", [2, 4])
def test_a_zeroed_shard_of_heads_moves_the_decode(tp):
    """The control: after the prefill, one shard's kv heads zeroed in every
    layer's cache move the next decode step's logits past the limit."""
    case = "qwen3_8b kv4"
    cfg, tcfg, jparams, model, mesh = _served(case, tp)
    prompt = _rng("prompt", case).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(tp=tp), capacity=CAPACITY)
    tpre, tdec, _ = make_serve_fns(tcfg, ShardCtx(tp=tp), mesh=mesh, capacity=CAPACITY)
    with jops.local_backend("xla"):
        jl, jc = jpre(jparams, jnp.asarray(prompt))
        nxt = np.asarray(jnp.argmax(jl[..., :cfg.vocab], -1)).astype(np.int32)[:, None]
        jl, _ = jdec(jparams, jc, jnp.asarray(nxt), jnp.asarray(PROMPT, jnp.int32))
    _, tc = tpre(model, torch.from_numpy(prompt))
    for _, c in _blocks(tc):
        c.k[-1].zero_()
        c.v[-1].zero_()
    tl, _ = tdec(model, tc, torch.from_numpy(nxt), torch.tensor(PROMPT, dtype=torch.int32))
    jl32 = np.asarray(jl.astype(jnp.float32))
    assert np.abs(tl.numpy() - jl32).max() > F32_TOL * np.abs(jl32).max()


def _block_params(tcfg, tp, sliced, devs):
    """One attention block's weights from a seed: in head slices over
    ``devs`` (``sliced``), or whole on the first."""
    rng = _rng("block", tp)
    spec = tatt.attn_spec(tcfg, ShardCtx(tp=tp))
    p = {n: torch.from_numpy((rng.normal(0, 0.2, s.shape) + (1.0 if n.endswith("norm") else 0))
                             .astype(np.float32)).to(compute) for n, s in spec.items()
         for compute in [torch.float32 if n.endswith("norm") else getattr(torch, tcfg.dtype)]}
    if not sliced:
        return {n: w.to(devs[0]) for n, w in p.items()}
    dims = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    return {n: TP.split(w, dims[n], devs).parts if n in dims else w.to(devs[0])
            for n, w in p.items()}


@pytest.mark.parametrize("sliced", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_head_placed_decode_is_the_slot_split_decode_bit_for_bit(tp, dtype, sliced):
    """One attention block's decode step against a cache by kv heads equals
    the split-S decode against the same cache split by slots bit for bit:
    the output and the written cache, with the weights in head slices and
    whole."""
    _, tcfg = _cfgs("qwen3_8b kv4", dtype)
    devs = [torch.device(d) for d in CARDS[:tp]]
    mesh = make_mesh(1, tp, devices=CARDS[:tp])
    p = _block_params(tcfg, tp, sliced, devs)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_rng("x", tp).normal(size=(2, 10, tcfg.d_model)).astype(np.float32)
                         ).to(device=devs[0], dtype=dt)
    pos = torch.arange(10, device=devs[0])[None].expand(2, 10)
    ctx = ShardCtx(tp=tp)
    cache = tatt.init_kv_cache(tcfg, 2, 16, device=devs[0])
    _, cache = tatt.attention_block(p, tcfg, x[:, :9], pos[:, :9], cache=cache, mesh=mesh,
                                    ctx=ctx)
    outs = {}
    for dim in (1, 2):
        placed = tatt.ShardedKVCache.split(cache, devs, dim)
        out, written = tatt.attention_block(p, tcfg, x[:, 9:], pos[:, 9:], cache=placed,
                                            mesh=mesh, ctx=ctx)
        assert isinstance(written, tatt.ShardedKVCache) and written.dim == dim
        outs[dim] = (out, written.gathered())
    (a, ca), (b, cb) = outs[1], outs[2]
    assert torch.equal(a, b)
    assert torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v) and int(ca.pos) == int(cb.pos)


@pytest.mark.parametrize("tp", [2, 4])
def test_head_placed_block_joins_and_scatters_nothing(tp, monkeypatch):
    """A prefill and a decode step of one attention block with its weights
    in head slices against a cache by kv heads: no ``tp.join`` (of q, k or v)
    and no ``tp.scatter`` (of the output); the output's parts are summed
    (``tp.collect``) as in the cache-free forward."""
    _, tcfg = _cfgs("qwen3_8b kv4")
    devs = [torch.device(d) for d in CARDS[:tp]]
    mesh = make_mesh(1, tp, devices=CARDS[:tp])
    p = _block_params(tcfg, tp, True, devs)
    x = torch.from_numpy(_rng("x", tp).normal(size=(2, 10, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(10)[None].expand(2, 10)
    calls = {"join": 0, "scatter": 0, "collect": 0}
    for name in calls:
        fn = getattr(TP, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(TP, name, counted)
    cache = lm.init_cache(tcfg, 2, 16, mesh=mesh)["groups"]["p0_attn"]
    cache = lm._index(cache, 0)
    assert isinstance(cache, tatt.ShardedKVCache) and cache.dim == 1
    for part in (slice(0, 9), slice(9, 10)):
        _, cache = tatt.attention_block(p, tcfg, x[:, part], pos[:, part], cache=cache,
                                        mesh=mesh, ctx=ShardCtx(tp=tp))
    assert calls == {"join": 0, "scatter": 0, "collect": 2}
    assert cache.dim == 1 and int(cache.pos) == 10


@pytest.mark.parametrize("case", ["qwen3_8b kv4", "qwen3_8b", "mamba2_2p7b",
                                  "recurrentgemma_9b"])
def test_a_prefix_caches_size_over_a_mesh_is_the_whole_caches(case):
    """A served prefix cache over ``make_mesh(1, 4)`` (``CacheResult``, as
    the engine charges it for eviction) counts every shard's slice once:
    its size equals that of the same prefill's cache with no mesh."""
    cfg, tcfg, jparams, model, mesh = _served(case, 4)
    whole = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              ctx=ShardCtx(tp=4))
    prompt = torch.from_numpy(_rng("prompt", case).integers(0, cfg.vocab, (2, PROMPT)))
    results = []
    for m, over in ((model, mesh), (whole, None)):
        logits, cache = make_serve_fns(tcfg, ShardCtx(tp=4), mesh=over,
                                       capacity=CAPACITY)[0](m, prompt)
        results.append(CacheResult(logits, cache, PROMPT))
    assert all(_layout(c) != "whole" for btype, c in _blocks(results[0].cache)
               if btype != "local_attn")
    assert results[0].nbytes == results[1].nbytes


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_placed_caches_give_the_whole_caches_logits(case, dtype, tp):
    """The same model over the same mesh with its caches placed and with
    them whole on the row's first device: a prefill of 12 tokens and 3
    decode steps give the same logits bit for bit (every op on a shard's
    part acts per head or per channel), but for the SSD's and RG-LRU's
    decode in float32, held within 1e-6 relative: the CPU's vectorised
    kernels round a few elements of a shard's slice otherwise than the same
    elements of the whole tensor (SiLU, as the SSD's conv applies it, takes
    a scalar path for a slice's tail), 2.4e-7 relative seen."""
    _, tcfg = _cfgs(case, dtype)
    mesh = make_mesh(1, tp, devices=CARDS[:tp])
    ctx = ShardCtx(tp=tp)
    model = lm.init_model(tcfg, ctx, seed=0, mesh=mesh)
    tokens = torch.from_numpy(_rng("tokens", case).integers(0, tcfg.vocab, (2, PROMPT + 3)))
    runs = []
    for cache in (lm.init_cache(tcfg, 2, CAPACITY, mesh=mesh),
                  lm.init_cache(tcfg, 2, CAPACITY, device=mesh.first)):
        logits = []
        with torch.no_grad():
            for start, stop in [(0, PROMPT)] + [(p, p + 1) for p in range(PROMPT, PROMPT + 3)]:
                out, cache, _ = lm.forward(model, tcfg, tokens[:, start:stop], ctx, mesh=mesh,
                                           cache=cache, start_pos=torch.tensor(start))
                logits.append(out)
        runs.append(logits)
    for step, (a, b) in enumerate(zip(*runs)):
        if case in ("mamba2_2p7b", "recurrentgemma_9b") and dtype == "float32" and step > 0:
            err = float((a - b).abs().max()) / float(b.abs().max())
            assert err <= 1e-6, (case, step, err)
        else:
            assert torch.equal(a, b), (case, dtype, step)


def test_send_moves_each_shards_tensors_in_one_copy():
    """``tp.send``: each shard that lies elsewhere gets its tensors (of
    mixed types, strided views among them) equal to what was sent, as views
    of one buffer on its device; a shard where they lie gets them as they
    are; a tensor that needs a gradient is refused."""
    rng = _rng("send")
    x = torch.from_numpy(rng.normal(size=(2, 3, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 3, 5)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.tensor([7, -3], dtype=torch.int64)
    parts = [(xs, b, pos[s % 2]) for s, xs in enumerate(x.chunk(4, -1))]
    here = torch.empty(0).device
    got = TP.send(parts, [here] + [torch.device(d) for d in CARDS[1:]])
    assert all(g is not p and g.data_ptr() == p.data_ptr() for g, p in zip(got[0], parts[0]))
    for want, have in zip(parts[1:], got[1:]):
        assert len({t.untyped_storage().data_ptr() for t in have}) == 1
        for w, h in zip(want, have):
            assert h.dtype == w.dtype and h.shape == w.shape and torch.equal(h, w)
    with pytest.raises(ValueError):
        TP.send([(x.requires_grad_(),)] * 2, [here, torch.device(CARDS[1])])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("start", [0, 5, 20])
def test_a_write_into_slots_sends_each_shard_only_its_tokens(tp, start, monkeypatch):
    """A multi-token write into a cache by slots: each shard is sent at
    most min(S, C/tp) tokens (cut on the first device), and the written
    cache equals ``_write`` into the whole cache, whatever slots the write
    starts from (clamped so that it fits, as XLA clamps an update)."""
    _, tcfg = _cfgs("qwen3_8b")
    devs = [torch.device(d) for d in CARDS[:tp]]
    rng = _rng("slots", tp, start)
    whole = tatt.init_kv_cache(tcfg, 2, CAPACITY, device="cpu")
    whole = tatt.KVCache(*(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
                           for t in (whole.k, whole.v)), torch.tensor(start, dtype=torch.int32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 1, PROMPT, tcfg.head_dim)).astype(np.float32))
            for _ in range(2))
    sent = []
    send = TP.send

    def spied(parts, devices):
        sent.extend(p[1].shape[2] for p in parts)
        return send(parts, devices)

    monkeypatch.setattr(TP, "send", spied)
    got = tatt._write_slots(tatt.ShardedKVCache.split(whole, devs), k, v).gathered()
    assert sent == [min(PROMPT, CAPACITY // tp)] * tp
    slot = min(start, CAPACITY - PROMPT)
    assert torch.equal(got.k, tatt._write(whole.k, k, torch.tensor(slot)))
    assert torch.equal(got.v, tatt._write(whole.v, v, torch.tensor(slot)))
    assert int(got.pos) == start + PROMPT
