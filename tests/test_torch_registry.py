"""The five registered models that phase 4k of ``chip_smoke.py`` serves and
trains on the card, on the CPU: the phase's depth reckoning, and the three
faults the phase showed (ROADMAP C15-C17).

- ``chip_smoke.reckon_depth`` (a plain function: the parameters a layer and
  outside the layers reckoned from the config's widths) against
  ``model_spec``'s parameter count and the parameters of the model built on
  ``meta`` at each cut, for serving and for training; the depths pinned.
- C15: the reference's ``OpportunisticServer`` takes a prompt of one
  sequence only, so a multi-codebook config cannot be served; the port's
  takes musicgen's (K, S) prompt and gives the reference's
  ``greedy_generate`` tokens (float32), its 1-D prompts as before.
- C16: a leaf of more than ``WHOLE_DRAW_MAX`` elements is drawn a slice of
  its first dimension at a time; a smaller one as before.
- C17: ``lm.forward`` runs its blocks under the config it is given, as the
  reference's ``forward`` does, not the one the model was made with.
- ``moe._route`` given experts (check 2 of an MoE replays the kernel run's
  experts in the plain run, the decode check the forward's in each step),
  equal to ``_route`` given the router's own choice; the decode on the
  forward's experts against the forward (``chip_smoke.routes_taken``);
  ``chip_smoke.train_cut``, which trains phase 4f's granite-MoE cut to 16
  layers through ``train_loop`` as the train launcher drives it.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.models.lm import forward as j_forward
from repro.serve.engine import greedy_generate as j_generate
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro.serve.session import OpportunisticServer as JServer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.probe import _meta_model
from repro_torch.models import SINGLE, base, params_from_numpy
from repro_torch.models.base import ParamSpec, param_count
from repro_torch.models.lm import forward as t_forward
from repro_torch.models.lm import model_spec
from repro_torch.serve import OpportunisticServer, greedy_generate, make_serve_fns

DEPTHS = [("musicgen_large", 48, 48), ("h2o_danube_3_4b", 24, 24), ("starcoder2_7b", 32, 16),
          ("qwen3_moe_30b_a3b", 48, 5), ("internvl2_76b", 39, 2)]


@pytest.mark.parametrize("arch,serve,train", DEPTHS)
def test_phase_4k_depth_reckoning_vs_model_spec(arch, serve, train):
    """Each cut's reckoned parameters equal ``model_spec``'s count and the
    meta model's; the bytes are the reckoning's rule at that count, within
    REG_BUDGET, and one layer more would pass it."""
    cfg = get_config(arch)
    for kind, layers, per_param in (("serve", serve, 2), ("train", train,
                                                          chip_smoke.TRAIN_STATE_BYTES)):
        r = chip_smoke.reckon_depth(cfg, kind)
        assert r["layers"] == layers, kind
        cut = dataclasses.replace(cfg, n_layers=layers)
        n = param_count(model_spec(cut))
        assert r["params"] == n == sum(p.numel() for p in _meta_model(cut, SINGLE, False)
                                       .parameters()), kind
        assert r["whole_params"] == param_count(model_spec(cfg)), kind
        extra = (chip_smoke.SERVE_SLACK if kind == "serve"
                 else chip_smoke.train_extra(cfg, layers))
        assert r["bytes"] == per_param * n + extra <= chip_smoke.REG_BUDGET, kind
        if layers < cfg.n_layers:
            more = r["outer"] + (layers + 1) * r["per_layer"]
            nxt = (chip_smoke.SERVE_SLACK if kind == "serve"
                   else chip_smoke.train_extra(cfg, layers + 1))
            assert per_param * more + nxt > chip_smoke.REG_BUDGET, kind


def _musicgen():
    cfg = dataclasses.replace(j_smoke("musicgen_large"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("musicgen_large"), dtype="float32")
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, tcfg, jparams, model


def test_c15_codebook_prompt_served_as_the_reference_decodes_it():
    """musicgen's (4, 24) prompt: the reference's server refuses it (C15,
    reproduced); the port's serves it cold, anticipated and prefilled in
    think time, and resubmitted, each with the reference's greedy tokens
    (4, 6), the warm request faster and the resubmission a cache hit."""
    cfg, tcfg, jparams, model = _musicgen()
    rng = np.random.default_rng(15)
    cold, warm = (rng.integers(0, cfg.vocab, (cfg.n_codebooks, 24)).astype(np.int32)
                  for _ in range(2))
    with pytest.raises(TypeError):
        JServer(cfg, jparams, capacity=64).request(cold, n_tokens=6)
    with jops.local_backend("xla"):
        jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(), capacity=64)
        want = {name: np.asarray(j_generate(cfg, jparams, jpre, jdec, jnp.asarray(p[None]), 6))[0]
                for name, p in (("cold", cold), ("warm", warm))}
    srv = OpportunisticServer(tcfg, model, capacity=64, device="cpu")
    out = srv.request(cold, n_tokens=6)
    cold_s = srv.metrics.interactions[-1].latency_s
    srv.anticipate(warm)
    srv.think(10.0)
    warm_out = srv.request(warm, n_tokens=6)
    warm_s = srv.metrics.interactions[-1].latency_s
    again = srv.request(warm, n_tokens=6)
    rec = srv.metrics.interactions[-1]
    assert out.tokens.shape == (cfg.n_codebooks, 6)
    np.testing.assert_array_equal(out.tokens, want["cold"])
    np.testing.assert_array_equal(warm_out.tokens, want["warm"])
    np.testing.assert_array_equal(again.tokens, want["warm"])
    assert warm_s < cold_s and rec.ops_executed == 0 and rec.latency_s == 0.0
    pre, dec, _ = make_serve_fns(tcfg, SINGLE, capacity=64)
    np.testing.assert_array_equal(
        greedy_generate(tcfg, model, pre, dec, torch.from_numpy(cold[None]).long(), 6)[0].numpy(),
        out.tokens)


def test_c16_large_leaf_drawn_a_slice_at_a_time(monkeypatch):
    """Over the limit, ``randn`` is asked for one slice of the first
    dimension at a time, slice i the generator's i-th draw; at the limit,
    the leaf is drawn whole, as before."""
    calls = []
    randn = torch.randn

    def recording(*args, **kwargs):
        out = randn(*args, **kwargs)
        calls.append(out.numel())
        return out

    monkeypatch.setattr(base, "WHOLE_DRAW_MAX", 80)
    monkeypatch.setattr(torch, "randn", recording)
    for shape, want_calls in (((3, 5, 8), [40] * 3), ((2, 5, 8), [80])):
        calls.clear()
        gen = torch.Generator().manual_seed(4)
        got = ParamSpec(shape, init="normal:0.5", at_use=True).materialise(gen, torch.bfloat16,
                                                                          "cpu")
        assert calls == want_calls and got.shape == shape and got.dtype == torch.bfloat16
        ref = torch.Generator().manual_seed(4)
        if len(want_calls) == 1:
            want = (randn(shape, generator=ref) * 0.5).to(torch.bfloat16)
        else:
            want = torch.stack([(randn(shape[1:], generator=ref) * 0.5).to(torch.bfloat16)
                                for _ in range(shape[0])])
        assert torch.equal(got, want)


def test_c17_forward_runs_blocks_under_the_given_config():
    """The smoke qwen3-moe made at capacity factor 1.25 (its router drops
    assignments at 128 tokens) and run under a config whose capacity keeps
    every one: the port's logits equal those of the model made under that
    config bit for bit and the reference's forward under it within 1e-5 of
    the largest |logit|; under the made config they differ."""
    cfg = dataclasses.replace(j_smoke("qwen3_moe_30b_a3b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("qwen3_moe_30b_a3b"), dtype="float32")
    keep_all = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    cfg2 = dataclasses.replace(cfg, moe=keep_all)
    tcfg2 = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                              capacity_factor=keep_all
                                                              .capacity_factor))
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    arrays = jax.tree.map(np.asarray, jparams)
    made, made2 = (params_from_numpy(arrays, c, device="cpu") for c in (tcfg, tcfg2))
    tokens = np.random.default_rng(17).integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    with jops.local_backend("xla"):
        jl, _, _ = j_forward(jparams, cfg2, jnp.asarray(tokens), JShardCtx())
    jl = np.asarray(jl)
    got = t_forward(made, tcfg2, torch.from_numpy(tokens), SINGLE)[0]
    assert torch.equal(got, t_forward(made2, tcfg2, torch.from_numpy(tokens), SINGLE)[0])
    np.testing.assert_allclose(got.numpy(), jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    dropping = t_forward(made, tcfg, torch.from_numpy(tokens), SINGLE)[0]
    assert not torch.allclose(dropping, got, rtol=0, atol=1e-5 * float(got.abs().max()))


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m"])
def test_route_given_experts_replays_them(arch):
    """``moe._route`` given the experts it chose itself returns its own
    weights and aux losses bit for bit (check 2 and the decode check replay
    another run's experts so); given other experts, their own normalised
    probabilities."""
    from repro_torch.models import moe

    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(18)
    E = cfg.moe.n_experts
    params = {"router": torch.from_numpy(rng.normal(0, 0.3, (cfg.d_model, E)).astype(np.float32))}
    xf = torch.from_numpy(rng.normal(size=(96, cfg.d_model)).astype(np.float32))
    w, e, aux = moe._route(params, cfg, xf, E)
    fw, fe, faux = moe._route(params, cfg, xf, E, top_e=e)
    assert torch.equal(fw, w) and torch.equal(fe, e)
    assert all(torch.equal(faux[k], aux[k]) for k in aux) and set(faux) == set(aux)
    other = torch.flip(torch.sort(e, -1).values, [0])
    ow, oe, _ = moe._route(params, cfg, xf, E, top_e=other)
    probs = torch.softmax(xf @ params["router"], -1).gather(-1, other)
    assert torch.equal(oe, other)
    torch.testing.assert_close(ow, probs / probs.sum(-1, keepdim=True), rtol=1e-6, atol=0)


def test_decode_on_the_forwards_experts_matches_the_forward():
    """``chip_smoke.routes_taken`` as the decode check uses it, on the smoke
    qwen3-moe in float32 with every assignment kept: a cache-free forward's
    experts recorded, then each one-token decode step replaying them takes
    exactly those, and its logits match the forward's within 1e-5 of the
    largest; a replay of other experts is taken too and counted as moved."""
    from repro_torch.models import init_cache, init_model

    base_cfg = dataclasses.replace(get_smoke_config("qwen3_moe_30b_a3b"), dtype="float32")
    cfg = dataclasses.replace(base_cfg, moe=dataclasses.replace(
        base_cfg.moe, capacity_factor=base_cfg.moe.n_experts / base_cfg.moe.top_k))
    model = init_model(cfg, seed=3, device="cpu")
    S = 12
    tokens = torch.from_numpy(np.random.default_rng(19).integers(0, cfg.vocab, (1, S)))
    with torch.no_grad(), chip_smoke.routes_taken(torch) as fwd:
        full, _, _ = t_forward(model, cfg, tokens, SINGLE)
    assert len(fwd) == cfg.n_layers and all(a is b for a, b in fwd)
    replay = [e[t:t + 1] for t in range(S) for e, _ in fwd]
    _, dec, _ = make_serve_fns(cfg, SINGLE, capacity=64)
    steps = []
    with torch.no_grad(), chip_smoke.routes_taken(torch, replay) as calls:
        cache = init_cache(cfg, 1, 64, "cpu")
        for t in range(S):
            last, cache = dec(model, cache, tokens[:, t:t + 1], torch.tensor(t, dtype=torch.int32))
            steps.append(last)
    assert len(calls) == len(replay)
    assert all(torch.equal(a, b) for (a, _), b in zip(calls, replay))
    got = torch.cat(steps, 0)
    torch.testing.assert_close(got, full[0], rtol=0, atol=1e-5 * float(full.abs().max()))
    other = [(e + 1) % cfg.moe.n_experts for e in replay[:cfg.n_layers]]
    with torch.no_grad(), chip_smoke.routes_taken(torch, other) as moved:
        dec(model, init_cache(cfg, 1, 64, "cpu"), tokens[:, :1], torch.tensor(0, dtype=torch.int32))
    assert len(moved) == cfg.n_layers and all(torch.equal(a, b) for (a, _), b in zip(moved, other))
    assert torch.equal(moved[0][1], replay[0]) and chip_smoke.moved_tokens(torch, moved)[0] == 1


@pytest.mark.parametrize("steps", [4, 100])
def test_train_cut_drives_the_loop_as_the_launcher_does(monkeypatch, steps):
    """``chip_smoke.train_cut`` (phase 4f's 16-layer granite-MoE, and the
    launcher's optimizer for 4k's cut models) hands ``train_loop`` the
    optimizer, data, seed, log rate and checkpoint period that the train
    launcher hands it at the same shape, on the config cut in depth."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop

    seen = []
    stats = types.SimpleNamespace(steps=steps, losses=[1.0], stragglers=0, checkpoints=0)

    def recording(cfg, run, data, **kwargs):
        seen.append((cfg, run, data, kwargs))
        return stats

    monkeypatch.setattr(launch_train, "train_loop", recording)
    monkeypatch.setattr(loop, "train_loop", recording)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", steps)
    whole = get_config("granite_moe_3b_a800m")
    launch_train.main(["--arch", "granite_moe_3b_a800m", "--full-config", "--steps", str(steps),
                       "--batch", "8", "--seq", "256", "--microbatch", "4", "--remat", "full",
                       "--seed", str(chip_smoke.TRAIN_SEED), "--ckpt-dir", "ck", "--device", "cpu"])
    cut = dataclasses.replace(whole, n_layers=16)
    run = RunConfig(model=cut, shape=ShapeConfig("cli", "train", seq_len=256, global_batch=8),
                    dp=1, tp=1, remat="full", microbatch=4)
    assert chip_smoke.train_cut(cut, run, "cpu", "ck", fail_at_step=2)[0] is stats
    (lcfg, lrun, ldata, lkw), (ccfg, crun, cdata, ckw) = seen
    assert lcfg == whole and ccfg == cut
    assert crun == dataclasses.replace(lrun, model=cut) and cdata == ldata
    assert ckw["opt"] == lkw["opt"] == chip_smoke.launcher_opt(steps)
    assert ckw["fail_at_step"] == 2 and lkw["fail_at_step"] is None
    for key in ("total_steps", "ckpt_dir", "ckpt_every", "seed", "log_every", "device"):
        assert ckw[key] == lkw[key], key


@pytest.mark.parametrize("Sq,Skv,causal,window,off,masked", [
    (64, 64, True, 64, 0, False),  # danube's training shape in small: the window cuts nothing
    (64, 64, True, 63, 0, True),
    (64, 64, True, 16, 0, True),
    (64, 64, True, None, 0, False),
    (32, 64, True, None, 32, True),  # a causal offset
    (64, 64, False, 70, 0, False),
])
def test_sdpa_yardstick_masks_only_where_the_mask_cuts(monkeypatch, Sq, Skv, causal, window, off,
                                                       masked):
    """``chip_smoke.sdpa_call``, phase 5's library time, computes the oracle's
    function, and hands SDPA a mask only where a window cuts a key or a
    causal offset needs one (a mask keeps it off its flash path)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    sdpa, masks = F.scaled_dot_product_attention, []

    def watched(*args, attn_mask=None, **kwargs):
        masks.append(attn_mask is not None)
        return sdpa(*args, attn_mask=attn_mask, **kwargs)

    monkeypatch.setattr(F, "scaled_dot_product_attention", watched)
    g = torch.Generator().manual_seed(7)
    q = torch.randn(1, 4, Sq, 16, generator=g)
    k, v = (torch.randn(1, 2, Skv, 16, generator=g) for _ in range(2))
    got = chip_smoke.sdpa_call(torch, fa, q, k, v, causal, window, off)
    want = fa.attention_ref(q, k, v, causal=causal, window=window, q_offset=off)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert masks == [masked]
