"""Checkpoints cross between the packages, and the port's fault tolerance.

A training state written by the JAX ``CheckpointManager`` restores in the
port's, and one written by the port restores in the JAX one, both bit for
bit, with the same manifest keys in the same order.  Then the port's own
atomicity and keep-k, async saves, and a run killed by ``fail_at_step``
that resumes and ends bit-equal to an uninterrupted run (CPU, exact).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.configs import get_smoke_config as j_smoke
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.train import optimizer as jopt
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SynthSpec
from repro_torch.models import params_from_numpy
from repro_torch.models.base import keystr, tree_flatten
from repro_torch.train import AdamWConfig, init_opt_state, train_loop


def _jax_state(seed=0):
    cfg = j_smoke("smollm_360m")
    params = j_init_model(cfg, JShardCtx(), seed=seed)
    opt = jopt.init_opt_state(params)
    rng = np.random.default_rng(seed)
    opt["mu"] = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
    opt["nu"] = jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape), jnp.float32), params)
    opt["step"] = jnp.asarray(7, jnp.int32)
    return {"params": params, "opt": opt}


def _port_template():
    cfg = get_smoke_config("smollm_360m")
    from repro_torch.models import init_model

    model = init_model(cfg, seed=1, device="cpu", trainable=True)
    return {"params": model.tree(), "opt": init_opt_state(model.tree())}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_jax_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    state = _jax_state()
    JManager(str(tmp_path)).save(5, state)
    m = CheckpointManager(str(tmp_path))
    assert m.latest_step() == 5
    got = m.restore(_port_template(), device="cpu")
    want = jax.tree.map(np.asarray, state)
    flat = tree_flatten(got)
    assert [keystr(p) for p, _ in flat] == [e["key"] for e in _manifest(tmp_path, 5)["leaves"]]
    for path, t in flat:
        w = want
        for k in path:
            w = w[k]
        assert t.numpy().dtype == np.asarray(w).dtype
        assert t.numpy().tobytes() == np.asarray(w).tobytes(), keystr(path)


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    state = _jax_state(seed=2)
    host = jax.tree.map(np.asarray, state)
    cfg = get_smoke_config("smollm_360m")
    model = params_from_numpy(host["params"], cfg, device="cpu", trainable=True)
    opt = {"mu": jax.tree.map(torch.from_numpy, host["opt"]["mu"]),
           "nu": jax.tree.map(torch.from_numpy, host["opt"]["nu"]),
           "step": torch.tensor(7, dtype=torch.int32)}
    CheckpointManager(str(port_dir)).save(9, {"params": model.tree(), "opt": opt})
    JManager(str(jax_dir)).save(9, state)
    assert _manifest(port_dir, 9) == _manifest(jax_dir, 9)
    got = JManager(str(port_dir)).restore(state)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(state)[0]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), jax.tree_util.keystr(path)


def test_atomicity_keep_k_and_async(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    m.save(10, tree)
    m.save_async(20, tree)
    m.wait()
    m.save(30, tree)
    assert m.latest_step() == 30
    assert not os.path.exists(tmp_path / "step_00000010")  # keep=2
    os.makedirs(tmp_path / ".tmp_step_00000099")  # a save that crashed mid-write
    assert m.latest_step() == 30
    out = m.restore(tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="shape"):
        m.restore({"a": torch.zeros(3, 2), "b": {"c": torch.ones(4)}})
    m.save(40, tree)  # the next save clears the partial directory
    assert not os.path.exists(tmp_path / ".tmp_step_00000099")


def test_fail_at_step_then_resume_equals_uninterrupted_run(tmp_path):
    cfg = get_smoke_config("smollm_360m")
    shape = ShapeConfig("tiny", "train", seq_len=32, global_batch=4)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=2)
    data = SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    kw = dict(total_steps=6, ckpt_every=2, opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                                           total_steps=6),
              log_fn=lambda s: None, device="cpu")
    whole = train_loop(cfg, run, data, ckpt_dir=str(tmp_path / "whole"), **kw)
    with pytest.raises(RuntimeError, match="^injected node failure at step 3$"):
        train_loop(cfg, run, data, ckpt_dir=str(tmp_path / "cut"), fail_at_step=3, **kw)
    # the periodic save at step 2 and the final save on the way out (step 3)
    assert CheckpointManager(str(tmp_path / "cut")).latest_step() == 3
    resumed = train_loop(cfg, run, data, ckpt_dir=str(tmp_path / "cut"), **kw)
    assert resumed.resumed_from == 3 and resumed.steps == 3
    assert resumed.losses == whole.losses[3:]
    for name in ("whole", "cut"):
        assert CheckpointManager(str(tmp_path / name)).latest_step() == 6
    a, b = (tmp_path / n / "step_00000006" for n in ("whole", "cut"))
    ma, mb = _manifest(tmp_path / "whole", 6), _manifest(tmp_path / "cut", 6)
    assert ma == mb
    for entry in ma["leaves"]:
        assert np.load(a / entry["file"]).tobytes() == np.load(b / entry["file"]).tobytes(), \
            entry["key"]
