"""Training under tensor parallelism (TP, and TP × FSDP) on the CPU, against
the JAX package: the cases of ``test_torch_tp_train.py`` for
``granite_moe_3b_a800m`` (an MoE, expert-parallel over the shards) and
``recurrentgemma_9b`` (RG-LRU + local attention), the resumed run, and the
SSD / RG-LRU blocks served under tp 4, on that file's helpers; what each
case holds is set out there.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.base import ShardCtx as JShardCtx
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import RunConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SynthSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import params_from_numpy
from repro_torch.models import tp as TP
from repro_torch.models.base import ShardCtx
from repro_torch.serve import make_serve_fns
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop
from test_torch_tp_train import (CARDS, F32_TOL, OPT, SHAPE, _cfgs, _reference, _rng,
                                 fsdp_vs_tp, one_thread, step_vs_reference)  # noqa: F401

HERE = ["granite_moe_3b_a800m", "recurrentgemma_9b"]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", HERE)
def test_tp_step_loss_and_every_gradient_vs_reference(arch, tp, remat):
    """The loss and every leaf's gradient of a step over ``make_mesh(1,
    tp)`` against ``jax.value_and_grad`` of the reference's ``loss_fn`` at
    ``ShardCtx(tp)`` (``test_torch_tp_train.step_vs_reference``)."""
    step_vs_reference(arch, tp, remat)


@pytest.mark.parametrize("arch,devices", [(a, d) for a in HERE for d in ("emulated", "distinct")])
def test_tp_fsdp_step_equals_the_tp_step_bit_for_bit(arch, devices, monkeypatch):
    """Two steps over ``make_mesh(2, 2)`` (TP × FSDP) equal two steps over
    ``make_mesh(1, 2)`` with microbatches of half the batch (an MoE: on the
    whole batch, which its ``(2, 2)`` step routes at one capacity), bit for
    bit (``test_torch_tp_train.fsdp_vs_tp``)."""
    fsdp_vs_tp(arch, devices, monkeypatch)


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_3b_a800m"])
def test_tp_fsdp_run_resumed_at_step_2_equals_three_steps(tmp_path, arch):
    """``train_loop`` over ``make_mesh(2, 2)`` with ``fsdp``, killed at step
    2, resumes from its exit checkpoint into the placed state in place and
    ends on the uninterrupted three steps' losses and files byte for byte."""
    _, tcfg = _cfgs(arch)
    run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), dp=2, tp=2, remat="full")
    data = SynthSpec(vocab=tcfg.vocab, seq_len=32, batch=4, seed=0)
    kw = dict(total_steps=3, ckpt_every=1, opt=topt.AdamWConfig(**OPT), log_fn=lambda s: None,
              device="cpu", mesh=make_mesh(2, 2, devices=CARDS), fsdp=True)
    whole = train_loop(tcfg, run, data, ckpt_dir=str(tmp_path / "whole"), **kw)
    with pytest.raises(RuntimeError, match="^injected node failure at step 2$"):
        train_loop(tcfg, run, data, ckpt_dir=str(tmp_path / "cut"), fail_at_step=2, **kw)
    resumed = train_loop(tcfg, run, data, ckpt_dir=str(tmp_path / "cut"), **kw)
    assert resumed.resumed_from == 2 and resumed.steps == 1
    assert resumed.losses == whole.losses[2:] and resumed.grad_norms == whole.grad_norms[2:]
    for name in ("whole", "cut"):
        assert CheckpointManager(str(tmp_path / name)).latest_step() == 3
    d1, d2 = (tmp_path / n / "step_00000003" for n in ("whole", "cut"))
    files = sorted(f for f in os.listdir(d1) if f.endswith(".npy"))
    assert files and all((d1 / f).read_bytes() == (d2 / f).read_bytes() for f in files)


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "recurrentgemma_9b"])
def test_ssd_and_rglru_served_under_tp4_vs_reference(arch):
    """Prefill of 12 tokens and 4 greedy decode steps through
    ``make_serve_fns`` over ``make_mesh(1, 4)`` (the SSD / RG-LRU
    projections in slices, the caches over the shards: the SSD state by
    heads, RG-LRU's by width, the conv tails by channels) against the
    reference's serve fns with no mesh: the same tokens, every step's logits
    within 1e-5 of the largest |logit|."""
    cfg, tcfg = _cfgs(arch)
    jparams = _reference(cfg, 4)
    mesh = make_mesh(1, 4, devices=CARDS)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, ctx=ShardCtx(tp=4),
                              mesh=mesh)
    block = "ssd" if arch == "mamba2_2p7b" else "rglru"
    assert isinstance(next(iter(model.groups.values())).tree()[block]["in_proj"], TP.Shards)
    prompt = _rng("serve", arch).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(tp=4), capacity=32)
    tpre, tdec, _ = make_serve_fns(tcfg, ShardCtx(tp=4), mesh=mesh, capacity=32)
    with jops.local_backend("xla"):
        jl, jc = jpre(jparams, jnp.asarray(prompt))
    with torch.no_grad():
        tl, tc = tpre(model, torch.from_numpy(prompt))
    for i in range(5):
        jl32 = np.asarray(jl.astype(jnp.float32))
        np.testing.assert_allclose(tl.numpy(), jl32, rtol=0, atol=F32_TOL * np.abs(jl32).max(),
                                   err_msg=f"step {i}")
        jn = np.asarray(jnp.argmax(jl[..., :cfg.vocab], -1)).astype(np.int32)
        assert np.array_equal(tl[..., :cfg.vocab].argmax(-1).numpy(), jn), f"step {i}"
        if i == 4:
            break
        pos = prompt.shape[-1] + i
        with jops.local_backend("xla"):
            jl, jc = jdec(jparams, jc, jnp.asarray(jn[:, None]), jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            tl, tc = tdec(model, tc, torch.from_numpy(jn[:, None]),
                          torch.tensor(pos, dtype=torch.int32))
