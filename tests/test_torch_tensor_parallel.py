"""Tensor parallelism of the dense weights (``repro_torch.models.tp``) on
the CPU, against the JAX package.

The mesh is emulated, as in ``test_torch_mesh.py``: ``make_mesh(..., devices=
["cpu"] * n)`` runs every shard on the CPU one after the other, and
``cpu:i`` devices stand for distinct cards (``.to("cpu:1")`` copies, so
each shard's slices are tensors of their own).  The reference shards its
dense weights with GSPMD over the ``model`` axis, which does not change the
answer: its ``forward`` at ``ShardCtx(tp)`` with no mesh (the padded vocab,
the padded experts) is what the port's tensor-parallel forward computes.

Held here:
- every registered config's placements at tp 2 and 4 (full size, on
  ``meta``): each leaf whose reference ``PartitionSpec`` names the model
  axis, the SSD and RG-LRU blocks' too, is held as slices of that
  dimension, one a shard; every other leaf whole on shard 0; each shard's
  bytes the placements' reckoning (``chip_smoke.tp_reckoning``), and phase
  4l's depths;
- the vocab-parallel embedding bit for bit against the whole lookup, at
  every id (the shards' edges among them), four codebooks too;
- the cache-free forward at tp 2 and 4 against the reference's forward at
  ``ShardCtx(tp)`` with no mesh, float32 and bfloat16, for nine smoke
  configs: ``qwen3_8b`` (qk-norm), ``h2o_danube_3_4b`` (a window),
  ``starcoder2_7b`` with as many kv heads as shards, ``musicgen_large``
  (codebooks: the head's columns straddle them), ``internvl2_76b`` (patch
  embeddings), ``recurrentgemma_9b`` (one kv head: q-only TP; the RG-LRU
  projections sliced), ``granite_moe_3b_a800m`` (TP attention with EP, and with the
  global MoE on the joined experts), ``smollm_360m`` with 3 q heads (no
  divisor of 2 or 4, as 15 is none of 4: attention whole, the MLP sliced),
  ``mamba2_2p7b`` (the SSD projections sliced);
- the flash_attention entry point called once a layer a shard at the
  shard's heads, on the shard's device, and the moves' profiler ranges;
- ``make_serve_fns`` over a TP mesh: prefill + 4 greedy decode steps
  against the reference's, tokens equal and logits within the float32
  limit (split-S cache, window ring, EP);
- a ``(2, 2)`` mesh (one set of slices a data row), a repeat bit for bit,
  ``params_from_numpy`` onto a TP mesh, the seeded draw into slices equal
  to the whole draw (also with leaves drawn a layer slice at a time), the
  SSD and RG-LRU blocks' projections in slices and their first block
  within the float32 limit, and the refusals.

Tolerances, taken from ``test_torch_mesh.py``: model logits in float32
within 1e-5 of the largest |logit|; in bfloat16 within 2^-5 of it, or the
reference's own bf16-to-float32 distance where that is larger.  What the
port computes the same way twice (a repeat, the embedding, the placement
of the same values) is held bit for bit.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.models.lm import forward as j_forward
from repro.models.lm import model_spec as j_model_spec
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import base, blocks, init_model, params_from_numpy
from repro_torch.models import tp as TP
from repro_torch.models.base import ShardCtx, keystr, tree_flatten
from repro_torch.models.layers import compute_dtype, embed_tokens
from repro_torch.models.lm import forward as t_forward
from repro_torch.models.lm import model_spec
from repro_torch.serve import make_serve_fns

CARDS = [f"cpu:{i}" for i in range(4)]
CPU = torch.device("cpu")
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _variant(arch, tp):
    """The smoke config's changes for a case: starcoder2 with as many kv
    heads as shards, smollm with 3 q heads (attention not TP-eligible)."""
    if arch == "starcoder2_7b":
        return dict(n_kv_heads=tp)
    if arch == "smollm_360m":
        return dict(n_q_heads=3, n_kv_heads=1)
    return {}


def _cfgs(arch, dtype, tp):
    kw = dict(_variant(arch, tp), dtype=dtype)
    return dataclasses.replace(j_smoke(arch), **kw), dataclasses.replace(get_smoke_config(arch), **kw)


def _inputs(cfg, key, B=2, S=12):
    rng = _rng("inputs", *key)
    shape = (B, S) if cfg.n_codebooks == 1 else (B, cfg.n_codebooks, S)
    tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    vis = (rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
           if cfg.n_vis_tokens else None)
    return tokens, vis


def _reference(cfg, tp, tokens, vis, seed=0):
    jctx = JShardCtx(tp=tp)
    jparams = j_init_model(cfg, jctx, seed=seed)
    with jops.local_backend("xla"):
        jl, _, jaux = j_forward(jparams, cfg, jnp.asarray(tokens), jctx,
                                vis_embeds=None if vis is None else jnp.asarray(vis))
    return jparams, np.asarray(jl.astype(jnp.float32)), jaux


def _tp_model(jparams, tcfg, tp, devices):
    mesh = make_mesh(1, tp, devices=devices)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, ctx=ShardCtx(tp=tp),
                              mesh=mesh)
    return model, mesh


def _run(model, tcfg, tp, mesh, tokens, vis, use_ep=False):
    return t_forward(model, tcfg, torch.from_numpy(tokens), ShardCtx(tp=tp), mesh=mesh,
                     vis_embeds=None if vis is None else torch.from_numpy(vis), use_ep=use_ep)


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# ------------------------------------------------------------- placements ----


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_slice_each_model_axis_leaf_one_slice_a_shard(arch, tp):
    """Full size, on meta: each leaf the reference's ``PartitionSpec``
    places on the model axis (the SSD and RG-LRU blocks' too) is held as
    ``tp`` slices of that dimension, slice ``s`` on shard ``s``; the rest
    whole on shard 0; each shard's bytes the reckoning of phase 4l."""
    cfg = get_config(arch)
    ctx = ShardCtx(tp=tp)
    spec = model_spec(cfg, ctx)
    want = dict(tree_flatten(j_model_spec(j_get_config(arch), JShardCtx(tp=tp))))
    compute = compute_dtype(cfg)
    devices = [torch.device("meta")] * tp
    placed = TP.map_paths(lambda path, s: TP.place(
        torch.empty(s.shape, dtype=s.dtype(compute), device="meta"), s.placement, path, devices),
        spec)
    n_split = 0
    for path, leaf in tree_flatten(placed):
        s = dict(tree_flatten(spec))[path]
        pspec = tuple(want[path].pspec)
        dim = next((i for i, a in enumerate(pspec) if a == "model"), None)
        if dim is None:
            assert isinstance(leaf, torch.Tensor) and tuple(leaf.shape) == s.shape, keystr(path)
            continue
        n_split += 1
        assert isinstance(leaf, TP.Shards) and leaf.dim == dim and leaf.shape == s.shape
        part = list(s.shape)
        part[dim] //= tp
        assert all(tuple(p.shape) == tuple(part) and p.is_contiguous() for p in leaf.parts)
    assert n_split > 0
    got = TP.shard_bytes(placed, tp)
    assert got == chip_smoke.tp_reckoning(cfg, ctx)
    total = sum(np.prod(s.shape) * s.dtype(compute).itemsize for _, s in tree_flatten(spec))
    assert sum(got) == total
    if arch == "internvl2_76b":  # no shard holds a whole stacked leaf
        assert max(got) < total / tp * 1.001


@pytest.mark.parametrize("arch,layers", [("internvl2_76b", 16), ("starcoder2_7b", 32)])
def test_phase_4l_depth_reckoning(arch, layers):
    """Phase 4l's depth: the deepest whose whole copy and its four slices,
    each reckoned from the placements, fit TP_BUDGET together."""
    r = chip_smoke.tp_depth(get_config(arch))
    assert r["layers"] == layers
    cut = dataclasses.replace(get_config(arch), n_layers=layers)
    per_shard = chip_smoke.tp_reckoning(cut, ShardCtx(tp=chip_smoke.TP_SHARDS))
    assert r["bytes"] == 2 * sum(per_shard) + chip_smoke.TP_SLACK <= chip_smoke.TP_BUDGET
    if layers < get_config(arch).n_layers:
        deeper = dataclasses.replace(cut, n_layers=layers + 1)
        assert 2 * sum(chip_smoke.tp_reckoning(deeper, ShardCtx(tp=chip_smoke.TP_SHARDS))) \
            + chip_smoke.TP_SLACK > chip_smoke.TP_BUDGET


# -------------------------------------------------------------- embedding ----


@pytest.mark.parametrize("devices", ["emulated", "distinct"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3_8b", "musicgen_large"])
def test_vocab_parallel_embedding_equals_the_whole_lookup_bit_for_bit(arch, tp, dtype, devices):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    ctx = ShardCtx(tp=tp)
    devs = ["cpu"] * tp if devices == "emulated" else CARDS[:tp]
    whole = init_model(cfg, ctx, seed=3, device="cpu")
    sliced = init_model(cfg, ctx, seed=3, mesh=make_mesh(1, tp, devices=devs))
    v = cfg.padded_vocab(tp)
    ids = np.arange(v)  # every id, the shards' edges among them
    shape = (1, v) if cfg.n_codebooks == 1 else (1, cfg.n_codebooks, v)
    tokens = torch.from_numpy(np.stack([np.roll(ids, 7 * k) for k in range(cfg.n_codebooks)])
                              .reshape(shape))
    tok = sliced.embed.tok
    assert isinstance(tok, TP.Shards) and tok.devices == tuple(torch.device(d) for d in devs)
    want = embed_tokens({"tok": whole.embed.tok}, cfg, tokens)
    got = embed_tokens({"tok": tok.at()}, cfg, tokens)
    assert _bits_equal(got, want)


# ---------------------------------------------------- the cache-free forward ----

FORWARD = ["qwen3_8b", "h2o_danube_3_4b", "starcoder2_7b", "musicgen_large", "internvl2_76b",
           "recurrentgemma_9b", "granite_moe_3b_a800m", "granite_moe_3b_a800m-global",
           "smollm_360m", "mamba2_2p7b"]


def _forward_case(name, dtype, tp, devices=None):
    arch = name.split("-")[0]
    use_ep = arch.startswith("granite") and not name.endswith("global")
    cfg, tcfg = _cfgs(arch, dtype, tp)
    tokens, vis = _inputs(cfg, (name, tp))
    jparams, jl, jaux = _reference(cfg, tp, tokens, vis)
    model, mesh = _tp_model(jparams, tcfg, tp, devices or ["cpu"] * tp)
    tl, _, taux = _run(model, tcfg, tp, mesh, tokens, vis, use_ep)
    return cfg, tcfg, tokens, vis, jl, jaux, model, mesh, tl, taux


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FORWARD)
def test_cache_free_forward_over_tp_shards_vs_reference(name, dtype, tp):
    """The forward over ``make_mesh(1, tp)`` with the weights in slices
    against the reference's ``forward`` at ``ShardCtx(tp)`` with no mesh."""
    cfg, tcfg, tokens, vis, jl, jaux, model, mesh, tl, taux = _forward_case(name, dtype, tp)
    assert model.tensor_parallel
    attn = [b.tree()["attn"] for b in model.groups.values() if "attn" in b.tree()]
    assert all(isinstance(a["wq"], TP.Shards) == tcfg.attn_tp_eligible(tp)
               and isinstance(a["wk"], TP.Shards) == tcfg.kv_sharded(tp) for a in attn)
    assert tl.shape == jl.shape
    rel = F32_TOL
    if dtype == "bfloat16":
        jl32 = _reference(_cfgs(name.split("-")[0], "float32", tp)[0], tp, tokens, vis)[1]
        rel = max(BF16_TOL, float(np.abs(jl - jl32).max() / np.abs(jl32).max()))
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0, atol=rel * np.abs(jl).max())
    assert set(taux) == set(jaux)
    for key in taux:
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-5 if dtype ==
                                                 "float32" else BF16_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_attention_runs_on_each_shards_heads_on_its_device(tp, monkeypatch):
    """The flash_attention entry point is called once a layer a shard, at
    the shard's q and kv heads (a CPU tensor's device has no index, so the
    shards' devices are the slices' own: ``Shards.devices``); a trace holds
    the moves' ranges (the forward of 8 positions runs its residual stream
    in sequence slices: its sums are the sequence's reduce-scatters)."""
    calls = []
    attention = kops.attention

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), q.device, k.device))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(kops, "attention", recording)
    cfg, tcfg = _cfgs("qwen3_8b", "float32", tp)
    tokens, vis = _inputs(cfg, ("heads", tp), B=1, S=8)
    jparams, jl, _ = _reference(cfg, tp, tokens, vis)
    model, mesh = _tp_model(jparams, tcfg, tp, CARDS[:tp])
    from torch.profiler import profile

    with profile() as prof:
        tl = _run(model, tcfg, tp, mesh, tokens, vis)[0]
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=F32_TOL * np.abs(jl).max())
    hq = cfg.n_q_heads // tp
    # qwen3's smoke config has one kv head: every shard reads it
    want = [((1, hq, 8, cfg.head_dim), (1, 1, 8, cfg.head_dim), CPU, CPU)
            for _ in range(cfg.n_layers) for s in range(tp)]
    assert calls == want
    wq = model.groups["p0_attn"].tree()["attn"]["wq"]
    assert wq.devices == tuple(torch.device(d) for d in CARDS[:tp])
    names = {e.key for e in prof.key_averages()}
    assert {"tp_broadcast", "tp_seq_gather", "tp_seq_scatter", "tp_gather"} <= names


# ----------------------------------------------------------------- serving ----


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3_8b", "h2o_danube_3_4b", "granite_moe_3b_a800m"])
def test_serve_fns_over_tp_shards_vs_reference(arch, tp):
    """Prefill of 12 tokens and 4 greedy decode steps through
    ``make_serve_fns(mesh=...)`` with the weights in slices (qwen3: a cache
    split by slot, split-S decode; danube: the window's ring, whole on the
    first device; granite: expert-parallel) against the reference's serve
    fns with no mesh: the same tokens, every step's logits within 1e-5 of
    the largest |logit|."""
    cfg, tcfg = _cfgs(arch, "float32", tp)
    tp_ctx, jctx = ShardCtx(tp=tp), JShardCtx(tp=tp)
    jparams = j_init_model(cfg, jctx, seed=0)
    model, mesh = _tp_model(jparams, tcfg, tp, ["cpu"] * tp)
    prompt = _inputs(cfg, ("serve", arch, tp))[0]
    capacity = 32 if cfg.window is None else cfg.window
    jpre, jdec, _ = j_serve_fns(cfg, jctx, capacity=capacity)
    tpre, tdec, _ = make_serve_fns(tcfg, tp_ctx, mesh=mesh, capacity=capacity,
                                   use_ep=tcfg.moe is not None)
    with jops.local_backend("xla"):
        jl, jc = jpre(jparams, jnp.asarray(prompt))
    tl, tc = tpre(model, torch.from_numpy(prompt))
    for step in range(5):
        jl32 = np.asarray(jl.astype(jnp.float32))
        np.testing.assert_allclose(tl.numpy(), jl32, rtol=0, atol=F32_TOL * np.abs(jl32).max(),
                                   err_msg=f"step {step}")
        jn = np.asarray(jnp.argmax(jl[..., :cfg.vocab], -1)).astype(np.int32)
        assert np.array_equal(tl[..., :cfg.vocab].argmax(-1).numpy(), jn), f"step {step}"
        if step == 4:
            break
        pos = prompt.shape[-1] + step
        with jops.local_backend("xla"):
            jl, jc = jdec(jparams, jc, jnp.asarray(jn[:, None]), jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(model, tc, torch.from_numpy(jn[:, None]),
                      torch.tensor(pos, dtype=torch.int32))


# ---------------------------------------- meshes, repeats, conversions, draws ----


@pytest.mark.parametrize("devices", ["emulated", "distinct"])
def test_forward_over_a_two_by_two_mesh(devices):
    """Two data rows of two shards: each row runs its half of the batch on
    its own set of slices (the model's replica for row 1 over distinct
    devices); the logits on the mesh's first device within the float32
    limit of the reference's."""
    cfg, tcfg = _cfgs("qwen3_8b", "float32", 2)
    tokens, vis = _inputs(cfg, ("2x2", devices))
    jparams, jl, _ = _reference(cfg, 2, tokens, vis)
    devs = ["cpu"] * 4 if devices == "emulated" else CARDS
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, ctx=ShardCtx(tp=2),
                              mesh=make_mesh(2, 2, devices=devs))
    mesh = make_mesh(2, 2, devices=devs)
    tl = _run(model, tcfg, 2, mesh, tokens, vis)[0]
    assert tl.device == CPU
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=F32_TOL * np.abs(jl).max())
    reps = model.__dict__.get("_replicas", {})
    if devices == "distinct":
        row1 = (torch.device("cpu:2"), torch.device("cpu:3"))
        assert list(reps) == [row1] and reps[row1].embed.tok.devices == row1
    else:
        assert not reps  # one device repeated: row 1 reads row 0's slices


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repeat_in_a_fresh_mesh_is_bit_for_bit(dtype):
    cfg, tcfg = _cfgs("internvl2_76b", dtype, 4)
    tokens, vis = _inputs(cfg, ("repeat", dtype))
    jparams = j_init_model(cfg, JShardCtx(tp=4), seed=0)
    outs = []
    for _ in range(2):
        model, mesh = _tp_model(jparams, tcfg, 4, CARDS)
        outs.append(_run(model, tcfg, 4, mesh, tokens, vis)[0])
    assert _bits_equal(outs[0], outs[1])


@pytest.mark.parametrize("tp", [2, 4])
def test_params_from_numpy_onto_a_tp_mesh_slices_the_whole_conversion(tp):
    cfg, tcfg = _cfgs("granite_moe_3b_a800m", "bfloat16", tp)
    jparams = jax.tree.map(np.asarray, j_init_model(cfg, JShardCtx(tp=tp), seed=1))
    whole = params_from_numpy(jparams, tcfg, device="cpu", ctx=ShardCtx(tp=tp))
    sliced = params_from_numpy(jparams, tcfg, ctx=ShardCtx(tp=tp),
                               mesh=make_mesh(1, tp, devices=CARDS[:tp]))
    _held_as_slices_of(sliced.tree(), whole.tree(), tp, CARDS[:tp])


def _held_as_slices_of(sliced, whole, tp, devices):
    devs = tuple(torch.device(d) for d in devices)
    flat = dict(tree_flatten(whole))
    n = 0
    for path, leaf in tree_flatten(sliced):
        w = flat[path]
        if isinstance(leaf, TP.Shards):
            n += 1
            assert leaf.devices == devs and leaf.shape == tuple(w.shape)
            assert _bits_equal(torch.cat(leaf.parts, leaf.dim), w), keystr(path)
        else:
            assert leaf.device.type == devs[0].type and _bits_equal(leaf, w), keystr(path)
    assert n > 0


@pytest.mark.parametrize("arch", ["internvl2_76b", "recurrentgemma_9b", "qwen3_moe_30b_a3b"])
@pytest.mark.parametrize("slice_at_a_time", [False, True])
def test_seeded_draw_into_slices_equals_the_whole_draw(arch, slice_at_a_time, monkeypatch):
    """``init_model(..., mesh=)`` draws the same values as ``init_model``
    whole on the first device, also where leaves are drawn a layer slice at
    a time (``WHOLE_DRAW_MAX`` lowered: the slices are split as drawn)."""
    if slice_at_a_time:
        monkeypatch.setattr(base, "WHOLE_DRAW_MAX", 2000)
    cfg = get_smoke_config(arch)
    ctx = ShardCtx(tp=4)
    whole = init_model(cfg, ctx, seed=5, device="cpu")
    sliced = init_model(cfg, ctx, seed=5, mesh=make_mesh(1, 4, devices=CARDS))
    _held_as_slices_of(sliced.tree(), whole.tree(), 4, CARDS)
    big = [s for _, s in tree_flatten(model_spec(cfg, ctx)) if not s.drawn_whole]
    assert bool(big) == slice_at_a_time


@pytest.mark.parametrize("arch,block", [("mamba2_2p7b", "ssd_block"),
                                        ("recurrentgemma_9b", "rglru_block")])
def test_ssd_and_rglru_blocks_keep_whole_weights_and_answers(arch, block, monkeypatch):
    """Under a TP mesh the SSD and RG-LRU blocks hold ``in_proj`` in column
    slices and ``out_proj`` in row slices over the shards, as the
    reference's placements say (a plain 1/tp of ``in_proj``'s columns: the
    SSD's cut across its z / x / B / C / dt segments), and keep every other
    leaf whole on the row's first device (the conv, the decays, the skip,
    the norm, RG-LRU's two gates); the first such block's output (its input
    is the embedding, bit for bit the whole lookup's) equals the no-mesh
    forward's within the float32 limit, and a repeat bit for bit."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ctx = ShardCtx(tp=4)
    whole = init_model(cfg, ctx, seed=0, device="cpu")
    mesh = make_mesh(1, 4, devices=CARDS)
    sliced = init_model(cfg, ctx, seed=0, mesh=mesh)
    kind = block.split("_")[0]
    n = 0
    for path, leaf in tree_flatten(sliced.tree()):
        if len(path) < 3 or path[2] != kind:
            continue
        n += 1
        if path[-1] in ("in_proj", "out_proj"):
            assert isinstance(leaf, TP.Shards) and leaf.dim == (2 if path[-1] == "in_proj" else 1)
            assert leaf.devices == tuple(torch.device(d) for d in CARDS)
        else:
            assert isinstance(leaf, torch.Tensor) and leaf.device == CPU, keystr(path)
    assert n > 2
    seen = []
    fn = getattr(blocks, block)

    def recording(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(TP.join_seq(out[0]))  # over the shards, in sequence slices
        return out

    monkeypatch.setattr(blocks, block, recording)
    tokens = torch.from_numpy(_inputs(cfg, ("ssm", arch))[0])
    t_forward(whole, cfg, tokens, ctx)
    first = seen[0]
    seen.clear()
    t_forward(sliced, cfg, tokens, ctx, mesh=mesh)
    t_forward(sliced, cfg, tokens, ctx, mesh=mesh)
    np.testing.assert_allclose(seen[0].numpy(), first.numpy(), rtol=0,
                               atol=F32_TOL * float(first.abs().max()))
    assert _bits_equal(seen[0], seen[len(seen) // 2])


def test_tensor_parallel_models_serve_only_at_their_mesh_context():
    """A model over a mesh of ``tp > 1`` shards is made at the mesh's
    ``ShardCtx(tp)``, or refused; made trainable (the train storage, each
    model-axis leaf in slices over the shards), it is placed as training
    places it, from ``init_model`` and from ``params_from_numpy`` alike."""
    cfg = get_smoke_config("qwen3_8b")
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    trained = init_model(cfg, ShardCtx(tp=2), trainable=True, mesh=mesh)
    assert trained.placed_tp and not trained.tensor_parallel
    with pytest.raises(ValueError, match="a mesh of 2 model shards under ShardCtx\\(tp=4\\)"):
        init_model(cfg, ShardCtx(tp=4), mesh=mesh)
    tree = jax.tree.map(np.asarray, j_init_model(j_smoke("qwen3_8b"), JShardCtx(tp=2)))
    with pytest.raises(ValueError, match="at its mesh's ShardCtx\\(tp=2\\), not at tp=1"):
        params_from_numpy(tree, cfg, ctx=ShardCtx(), mesh=mesh)
    converted = params_from_numpy(tree, cfg, ctx=ShardCtx(tp=2), trainable=True, mesh=mesh)
    assert converted.placed_tp
    # a mesh of one shard makes the whole model on its first device
    one = init_model(cfg, ShardCtx(), seed=0, mesh=make_mesh(1, 1, devices=["cpu"]))
    assert not one.tensor_parallel and one.device == torch.device("cpu")
