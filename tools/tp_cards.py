"""``internvl2_76b`` served at all 80 layers over four cards of one host,
tensor parallel (``repro_torch.models.tp``).

Builds the attention kernels, then: the model (141 GB of bf16 weights)
drawn straight into its slices over ``make_mesh(1, 4)``, each card holding a
quarter of every leaf whose placement names the model axis (the norms whole
on the first), each card's bytes the placements' reckoning
(``chip_smoke.tp_reckoning``); the cache-free forward over 4,352 positions
(256 patch embeddings and 4,096 tokens) with each layer's attention on each
card's 16 heads, layer 0 against float64 and a repeat in a fresh mesh bit
for bit; a 1,024-token prefill and 16 greedy decode steps through
``make_serve_fns(mesh=...)`` with the caches by kv heads (2 of the 8 a card,
where the reference's ``make_cache_specs`` places them: each card's cache
bytes against that reckoning after the prefill and after the last step,
each slice on its card; each card writes and attends its own heads), each
step's logits against the cache-free forward over the prompt and the tokens
(phase 4k's check, held at ``chip_smoke.TP_HOLD_DEPTH`` layers and printed
at 80); a traced decode step's joins and scatters (only the head's logits
join); the prefill wall, ms a decode token (beside the same tokens decoded
from caches whole on the first card, in the same process), a traced
prefill with each layout (the host's costliest ops) and each card's peak
memory,
beside the cards' ``nvidia-smi`` names and power limits.  Exits 2 on a host
with fewer than four cards.

    python3 tools/tp_cards.py
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def traced(torch, fn, devices):
    """``fn()`` under torch.profiler, every card synchronized → (wall ms,
    device ms of kernels and copies on all cards, the host's eight costliest
    ops by their own time: [(ms, calls, name)])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for d in devices:
            torch.cuda.synchronize(d)
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    device = sum(e.self_device_time_total for e in avg if e.device_type == DeviceType.CUDA) / 1e3
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in avg
                   if e.device_type == DeviceType.CPU), reverse=True)[:8]
    return wall, device, host


def four_cards(torch, smoke, devices):
    """The run, with ``smoke`` the ``chip_smoke`` module (its checks,
    constants and phase 4l's helpers)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, init_model
    from repro_torch.models import tp as TP
    from repro_torch.serve import make_serve_fns

    check, n = smoke.check, smoke.TP_SHARDS
    cfg = get_config("internvl2_76b")
    ctx = ShardCtx(tp=n)
    mesh = make_mesh(1, n, devices=devices)
    first = mesh.first
    for d in devices:
        torch.empty(1, device=d)  # each card's allocator made before its peak is reset
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    model = init_model(cfg, ctx, seed=smoke.SERVE_SEED, mesh=mesh)
    for d in devices:
        torch.cuda.synchronize(d)
    got, want = TP.shard_bytes(model.tree(), n), smoke.tp_reckoning(cfg, ctx)
    check(got == want, f"the cards hold {got} bytes, the placements reckon {want}")
    print(f"[tp-cards] {cfg.name}, all {cfg.n_layers} layers, drawn into its slices over "
          f"{[str(d) for d in devices]} in {time.perf_counter() - t0} s: each card's bytes {got} "
          f"(the placements' reckoning); peak while made "
          f"{[torch.cuda.max_memory_allocated(d) for d in devices]}", flush=True)

    rng = np.random.default_rng(smoke.SERVE_SEED + 2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, smoke.REG_SEQ)), device=first)
    vis = smoke.vis_embeds(torch, cfg, 1, first, seed=smoke.SERVE_SEED)
    t0 = time.perf_counter()
    logits, seen = smoke.tp_forward(torch, cfg, model, tokens, ctx, mesh, vis)
    for d in devices:
        torch.cuda.synchronize(d)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()), "the forward's logits are not finite")
    l0 = smoke.tp_layer0(torch, cfg, model, seen["x"], {"tp": seen["out"]})["tp"]
    check(l0 <= smoke.TP_TOL, f"layer 0 max |err| {l0} of the largest |float64| value, over "
          f"{smoke.TP_TOL}")
    again = smoke.tp_forward(torch, cfg, model, tokens, ctx, make_mesh(1, n, devices=devices),
                             vis)[0]
    check(torch.equal(again, logits), "a repeat in a fresh mesh gave other logits")
    print(f"[tp-cards] cache-free forward over {smoke.REG_SEQ + cfg.n_vis_tokens} positions "
          f"{fwd_ms} ms (the first; attention once a layer a card); layer 0 against float64 "
          f"{l0} (limit {smoke.TP_TOL}); a repeat in a fresh mesh bit for bit", flush=True)
    del logits, again, seen

    P, hold, cap = smoke.TP_PROMPT, smoke.TP_HOLD_DEPTH, smoke.TP_CAPACITY
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, P)), device=first)
    worst, seen = {}, []
    for c in (dataclasses.replace(cfg, n_layers=hold), cfg):
        pre, dec = make_serve_fns(c, ctx, mesh=mesh, capacity=cap)[:2]
        pre = smoke.checked_prefill(torch, c, pre, mesh, cap, seen)
        toks, steps, pre_ms, dec_ms, cache = smoke.mesh_generate(torch, c, model, pre, dec,
                                                                 prompt)
        if c.n_layers == hold:  # a decode step traced at the held depth
            nxt = torch.zeros((1, 1), dtype=torch.int32, device=first)
            pos = torch.tensor(P + smoke.N_TOKENS, dtype=torch.int32, device=first)
            gathers, scatters = smoke.decode_moves(torch, lambda: dec(model, cache, nxt, pos))
        seq = torch.cat([prompt, toks.to(prompt.dtype)], 1)
        # the forward kernel tiles 128 positions; causal, so the padding moves no logit before it
        seq = torch.cat([seq, seq.new_zeros(1, -seq.shape[1] % 128)], 1)
        full = smoke.tp_forward(torch, c, model, seq, ctx, mesh, None)[0]
        errs = [smoke.logits_err(torch, a[:, None], full[:, P - 1 + t][:, None])
                for t, a in enumerate(steps)]
        worst[c.n_layers] = max(e / s for e, s in errs)
        del full, seq
    last = smoke.cache_cards(torch, cfg, cache, mesh, 1, cap, "after the last decode step")
    check(gathers == 1 and scatters == 0, f"a decode step ran {gathers} tp_gather ranges and "
          f"{scatters} scatters: the attention joined its q, k, v or scattered its output")
    del cache
    _, _, pre_ms2, dec_ms2, _ = smoke.mesh_generate(torch, cfg, model, pre, dec, prompt)
    pre_wc, dec_wc, wc_err = smoke.whole_cache_decode(
        torch, cfg, model, smoke.whole_cache_prefill(torch, cfg, ctx, mesh, cap), dec, prompt,
        toks, steps)
    check(wc_err <= smoke.TP_TOL, f"the decode from caches whole on the first card moved "
          f"{wc_err} of the largest |logit| from the placed caches', over {smoke.TP_TOL}")
    # where a prefill's time goes, the caches placed and whole
    whole_pre = smoke.whole_cache_prefill(torch, cfg, ctx, mesh, cap)
    for label, fn in (("placed", make_serve_fns(cfg, ctx, mesh=mesh, capacity=cap)[0]),
                      ("whole", whole_pre)):
        wall, device, host = traced(torch, lambda: fn(model, prompt), devices)
        print(f"[tp-cards] a traced {P}-token prefill at {cfg.n_layers} layers, the caches "
              f"{label}: {wall} ms wall, {device} ms on the cards; the host's costliest ops "
              f"(own ms, calls): " + json.dumps([(round(t, 3), n, k[:60]) for t, n, k in host]),
              flush=True)
    check(worst[hold] <= smoke.TP_TOL, f"decode at {hold} layers moved {worst[hold]} of the "
          f"largest |logit| from the cache-free forward's, over {smoke.TP_TOL}")
    peaks = [torch.cuda.max_memory_allocated(d) for d in devices]
    check(max(peaks) < 80e9, f"a card's peak {max(peaks)} bytes")
    print(f"[tp-cards] a {P}-token prefill and {smoke.N_TOKENS} greedy decode steps at "
          f"{cfg.n_layers} layers: prefill {pre_ms} / {pre_ms2} ms, decode {dec_ms} / {dec_ms2} "
          f"ms a token; in the same process with the caches whole on the first card: prefill "
          f"{pre_wc} ms, decode {dec_wc} ms a token, its logits {wc_err} of the largest from the "
          f"placed caches'; each step's logits against the cache-free forward over the prompt and "
          f"the tokens, worst max |err| over the largest |logit| by depth {json.dumps(worst)} "
          f"(held at {hold}, limit {smoke.TP_TOL}); each card's peak {peaks} bytes; the caches "
          f"by kv heads, each card's bytes the reckoning from make_cache_specs after the prefill "
          f"{seen[-1]} and after the last step {last}; a traced decode step at {hold} layers "
          f"{gathers} tp_gather range (the head's logits), {scatters} scatters", flush=True)


def main() -> int:
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < smoke.TP_SHARDS:
        print(f"tp_cards: needs {smoke.TP_SHARDS} cards, found {cards}", file=sys.stderr)
        return 2
    smoke.card_setup(torch, ["flash_attention"])
    t0 = time.perf_counter()
    four_cards(torch, smoke, [torch.device("cuda", i) for i in range(smoke.TP_SHARDS)])
    print(f"[tp-cards] took {time.perf_counter() - t0} s", flush=True)
    print(json.dumps({"ok": True, "cards": [torch.cuda.get_device_name(i)
                                            for i in range(smoke.TP_SHARDS)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
