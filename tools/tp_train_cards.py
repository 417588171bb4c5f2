"""Training under tensor parallelism over four cards of one host: TP × FSDP,
the reference's Megatron and ZeRO placements, through the train launcher's
code path (``repro_torch.launch.train`` / ``train_loop``).

Builds the attention kernels, then:

- ``qwen3_8b`` at all 36 layers, ``--dp 2 --tp 2 --fsdp``: 3 steps of 2 x
  4,096 tokens through ``launch.train.main`` (each card holding its quarter
  of the float32 weights and moments, ``chip_smoke.tp_train_reckoning``),
  then the same run again, bit for bit; beside it, on the same cards,
  FSDP over four data rows, ``--dp 4 --fsdp`` (3 steps of 4 x 4,096 tokens);
- ``qwen3_moe_30b_a3b`` at the deepest depth whose reckoned bytes a card
  stay within 76 GB (``chip_smoke.tp_train_depth``: the first row's cards
  hold the whole batch's activations, which the MoE routes there at one
  capacity, as the reference's ``moe_ffn``), the same 2 x 2 mesh, through
  ``train_loop`` with the launcher's optimizer, seed and log rate (the
  launcher takes no depth cut), twice, bit for bit;
- each model's layer 0 over the cards (1 x 1,024 tokens) against float64
  with the whole weights (the MoE's experts on the cards' routing).

Prints each run's warm step ms, tokens/s, its kernel launches, each card's
state bytes beside the reckoning and each card's peak, with the cards'
``nvidia-smi`` names and power limits.  Exits 2 on a host with fewer than
four cards.

    python3 tools/tp_train_cards.py
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CARDS = 4
STEPS = 3
SEQ = 4096
LAYER0_TOKENS = 1024


def recorded_states(loop_module):
    """``train_loop``'s ``init_placed_state`` watched: each state it makes
    is appended to the list yielded (the model and the optimizer state)."""
    made = []
    fn = loop_module.init_placed_state

    def recording(*args, **kwargs):
        made.append(fn(*args, **kwargs))
        return made[-1]

    loop_module.init_placed_state = recording
    return made, lambda: setattr(loop_module, "init_placed_state", fn)


def run(torch, smoke, name, devices, train, dp, tp, batch):
    """``train()`` (a launcher or ``train_loop`` run) with each card's peak
    reset first → (its LoopStats, each card's state bytes, each card's
    peak); prints the run's line, its kernel launches among it."""
    from repro_torch.kernels import ops
    from repro_torch.train import loop
    from repro_torch.train.trainstep import card_state_bytes

    for d in devices:
        torch.empty(1, device=d)  # each card's allocator made before its peak is reset
        torch.cuda.reset_peak_memory_stats(d)
    made, restore = recorded_states(loop)
    before = ops.launch_counts()
    try:
        t0 = time.perf_counter()
        stats = train()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = {k: n - before[k] for k, n in ops.launch_counts().items() if n > before[k]}
    held = card_state_bytes(*made[0])
    del made
    gc.collect()
    torch.cuda.empty_cache()
    peaks = [torch.cuda.max_memory_allocated(d) for d in devices]
    warm = stats.step_times[1:]
    print(f"[tp-train-cards] {name} over ({dp}, {tp}): {stats.steps} steps of {batch} x {SEQ} "
          f"tokens in {wall} s; step ms {json.dumps([t * 1e3 for t in stats.step_times])}, warm "
          f"tokens/s {json.dumps([batch * SEQ / t for t in warm])}; losses "
          f"{json.dumps(stats.losses)}, grad norms {json.dumps(stats.grad_norms)}; each card's "
          f"weights and moments {held} bytes; each card's peak {peaks} bytes; launches "
          f"{json.dumps(launches)}", flush=True)
    smoke.check(all(math.isfinite(x) for x in stats.losses + stats.grad_norms),
                f"{name}: a loss or gradient norm is not finite")
    smoke.check(max(peaks) < 80e9, f"{name}: a card's peak {max(peaks)} bytes")
    return stats, held, peaks


def layer0(torch, smoke, cfg, devices):
    """Layer 0 over a ``(2, 2)`` mesh of ``devices`` (the train storage drawn
    from the seed as the runs draw it) on 1 x LAYER0_TOKENS tokens against
    float64 with its whole weights → max |err| over the largest |value|."""
    import numpy as np

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx
    from repro_torch.models.base import tree_map
    from repro_torch.models.lm import forward, init_placed

    ctx = ShardCtx(tp=2)
    mesh = make_mesh(2, 2, devices=devices)
    model = init_placed(cfg, ctx, mesh, smoke.TRAIN_SEED)
    first = mesh.first
    tokens = torch.as_tensor(np.random.default_rng(smoke.TRAIN_SEED).integers(
        0, cfg.vocab, (1, LAYER0_TOKENS)), device=first)
    cut = dataclasses.replace(cfg, n_layers=1)
    with torch.no_grad(), smoke.routes_taken(torch) as calls, \
            smoke.first_block(torch) as seen:
        forward(model, cut, tokens, ctx, mesh=mesh)
    block = next(iter(model.groups.values()))
    w = tree_map(lambda leaf: leaf.whole(first, layer=0), block.tree())
    del model
    with torch.no_grad():
        ref = smoke.layer0_f64(torch, cfg, w, seen["x"], calls[0][0] if calls else None, ctx)
        err = float((seen["out"].double() - ref).abs().max()) / float(ref.abs().max())
    del w, ref, seen
    torch.cuda.empty_cache()
    print(f"[tp-train-cards] {cfg.name} layer 0 over the cards, 1 x {LAYER0_TOKENS} tokens, "
          f"against float64 with the whole weights" + (" (its experts on the cards' routing)"
                                                     if calls else "")
          + f": max |err| over the largest |value| {err} (limit {smoke.TP_TOL})", flush=True)
    smoke.check(err <= smoke.TP_TOL, f"{cfg.name}: layer 0 over the cards {err} of the largest "
                f"|float64| value, over {smoke.TP_TOL}")


def four_cards(torch, smoke, devices):
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop

    check = smoke.check
    flags = ["--arch", "qwen3_8b", "--full-config", "--steps", str(STEPS), "--seq", str(SEQ),
             "--remat", "full", "--seed", str(smoke.TRAIN_SEED)]
    qwen = get_config("qwen3_8b")
    want = smoke.tp_train_reckoning(qwen, 2, 2, arrays=3)
    a = run(torch, smoke, "qwen3_8b, --dp 2 --tp 2 --fsdp", devices,
            lambda: smoke.quiet(launch_train.main, [*flags, "--batch", "2", "--dp", "2", "--tp",
                                                     "2", "--fsdp"])[0], 2, 2, 2)
    check(a[1] == want, f"qwen3_8b: the cards hold {a[1]} bytes of the state, the placements "
          f"reckon {want}")
    b = run(torch, smoke, "qwen3_8b, --dp 2 --tp 2 --fsdp again", devices,
            lambda: smoke.quiet(launch_train.main, [*flags, "--batch", "2", "--dp", "2", "--tp",
                                                     "2", "--fsdp"])[0], 2, 2, 2)
    check(a[0].losses == b[0].losses and a[0].grad_norms == b[0].grad_norms,
          "qwen3_8b: the run repeated gave other losses or gradient norms")
    c = run(torch, smoke, "qwen3_8b, --dp 4 --fsdp (FSDP over four rows)", devices,
            lambda: smoke.quiet(launch_train.main, [*flags, "--batch", "4", "--dp", "4",
                                                     "--fsdp"])[0], 4, 1, 4)
    check(c[1] == smoke.tp_train_reckoning(qwen, 4, 1, arrays=3), "qwen3_8b over (4, 1): the "
          "cards' bytes are not the placements' reckoning")
    layer0(torch, smoke, qwen, devices)

    moe = get_config("qwen3_moe_30b_a3b")
    r = smoke.tp_train_depth(moe, 2, 2, batch=2)
    cut = dataclasses.replace(moe, n_layers=r["layers"])
    print(f"[tp-train-cards] {moe.name} at {r['layers']} of {moe.n_layers} layers over (2, 2): "
          f"each card's state (weights, gradients, two moments) reckoned {r['cards']} bytes, "
          f"the fullest with the step's {r['bytes']:.0f} (limit {smoke.REG_BUDGET:.0f})",
          flush=True)
    run_cfg = RunConfig(model=cut, shape=ShapeConfig("cli", "train", SEQ, 2), dp=2, tp=2,
                        remat="full")
    data = SynthSpec(vocab=cut.vocab, seq_len=SEQ, batch=2, seed=smoke.TRAIN_SEED)

    def train_moe():
        return loop.train_loop(cut, run_cfg, data, total_steps=STEPS,
                               opt=smoke.launcher_opt(STEPS), seed=smoke.TRAIN_SEED,
                               log_every=max(1, STEPS // 10), log_fn=lambda line: None,
                               mesh=make_mesh(2, 2), fsdp=True)

    want = smoke.tp_train_reckoning(cut, 2, 2, arrays=3)
    m1 = run(torch, smoke, f"{moe.name} at {r['layers']} layers", devices, train_moe, 2, 2, 2)
    check(m1[1] == want, f"{moe.name}: the cards hold {m1[1]} bytes, the placements reckon "
          f"{want}")
    m2 = run(torch, smoke, f"{moe.name} at {r['layers']} layers again", devices, train_moe, 2,
             2, 2)
    check(m1[0].losses == m2[0].losses and m1[0].grad_norms == m2[0].grad_norms,
          f"{moe.name}: the run repeated gave other losses or gradient norms")
    layer0(torch, smoke, cut, devices)


def main() -> int:
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < CARDS:
        print(f"tp_train_cards: needs {CARDS} cards, found {cards}", file=sys.stderr)
        return 2
    smoke.card_setup(torch, ["flash_attention"])
    t0 = time.perf_counter()
    four_cards(torch, smoke, [torch.device("cuda", i) for i in range(CARDS)])
    print(f"[tp-train-cards] took {time.perf_counter() - t0} s", flush=True)
    print(json.dumps({"ok": True, "cards": [torch.cuda.get_device_name(i)
                                            for i in range(CARDS)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
