"""The port's training path against the JAX package's, on the CPU.

The smoke ``smollm_360m`` in float32 with the JAX parameters carried over
(``params_from_numpy(..., trainable=True)``): the loss and every leaf's
gradient against ``jax.value_and_grad`` of the JAX ``loss_fn`` (remat on and
off), a microbatched train step's loss and gradient norm against the JAX
step's, then AdamW fed the same gradients in both packages, the int8
error-feedback compression, ``lr_at``, the synthetic data's bytes and the
prefetch loader.

Tolerances: losses within 1e-6 relative; gradients within 1e-5 of each
leaf's largest |g| (float32 sums in another order; attention through the
plain version against ``attention_xla_chunked``); AdamW's params and
moments within 1e-6 relative (float32, the same formula; XLA may fuse a
multiply-add); compression and data exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.data import PrefetchLoader as JLoader
from repro.data import SynthSpec as JSynth
from repro.data import batch_at as j_batch_at
from repro.data import make_iterator as j_iter
from repro.kernels import ops as jops
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.train import optimizer as jopt
from repro.train.trainstep import loss_fn as j_loss_fn
from repro.train.trainstep import make_train_step as j_make_step
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import PrefetchLoader, SynthSpec, batch_at, make_iterator
from repro_torch.models import params_from_numpy
from repro_torch.models.base import SINGLE, keystr, tree_flatten
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop
from repro_torch.train.trainstep import init_train_state, make_train_step, value_and_grad

SHAPE = dict(name="tiny", kind="train", seq_len=32, global_batch=4)


def _setup(arch="smollm_360m", **run_kw):
    cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              trainable=True)
    data = batch_at(SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=1), 0)
    jrun = JRunConfig(model=cfg, shape=JShape(**SHAPE), dp=1, tp=1, **run_kw)
    trun = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), dp=1, tp=1, **run_kw)
    return cfg, tcfg, jparams, model, data, jrun, trun


def _assert_tree_close(got_tree, want_tree, rel, what):
    want_flat = dict((keystr(p), np.asarray(v)) for p, v in tree_flatten(want_tree))
    got_flat = dict((keystr(p), v) for p, v in tree_flatten(got_tree))
    assert set(got_flat) == set(want_flat)
    for key, want in want_flat.items():
        got = got_flat[key].detach().float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                                   err_msg=f"{what} {key}")


def _jtree(tree):
    """A JAX-package tree of arrays as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_vs_jax_value_and_grad(remat):
    cfg, tcfg, jparams, model, data, jrun, trun = _setup(remat=remat)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    with jops.local_backend("xla"):
        (jl, _), jg = jax.value_and_grad(
            lambda p: j_loss_fn(p, cfg, jbatch, JShardCtx(), None, remat != "none", False),
            has_aux=True)(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    tl, metrics, tg = value_and_grad(model, tcfg, tbatch, SINGLE, remat != "none")
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(metrics["loss"]) == pytest.approx(float(jl), rel=1e-6)
    _assert_tree_close(tg, _jtree(jg), 1e-5, "grad")


@pytest.mark.parametrize("microbatch,compression", [(2, False), (None, True)])
def test_train_step_vs_reference(microbatch, compression):
    """One step: the loss and the gradient norm (of the accumulated,
    possibly compressed gradient) as the JAX step reports them; the params
    within a few lr of the JAX step's (AdamW's first update is about ±lr a
    leaf, so a sign flip of a near-zero gradient moves a param by up to
    2 lr: the update itself is held exactly below, on shared gradients)."""
    cfg, tcfg, jparams, model, data, jrun, trun = _setup(
        remat="none", microbatch=microbatch, grad_compression=compression)
    opt_kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jstep, _ = j_make_step(cfg, jrun, opt=jopt.AdamWConfig(**opt_kw))
    jstate = jopt.init_opt_state(jparams)
    if compression:
        jstate["err"] = jopt.init_error_state(jparams)
    with jops.local_backend("xla"):
        jnew, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in data.items()})
    tstep, _ = make_train_step(tcfg, trun, opt=topt.AdamWConfig(**opt_kw))
    tstate = topt.init_opt_state(model.tree())
    if compression:
        tstate["err"] = topt.init_error_state(model.tree())
    model, tstate, tm = tstep(model, tstate, {k: torch.from_numpy(v) for k, v in data.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 1
    jnew = _jtree(jnew)
    for path, p in tree_flatten(model.tree()):
        np.testing.assert_allclose(p.detach().numpy(), _get(jnew, path), rtol=0, atol=2.5e-3,
                                   err_msg=keystr(path))
    if compression:
        # each carried error is under half an int8 step of its leaf in both
        # packages, so the two differ by at most one step
        jerr = _jtree(jstate["err"])
        for path, e in tree_flatten(tstate["err"]):
            want = _get(jerr, path)
            np.testing.assert_allclose(e.numpy(), want, rtol=0,
                                       atol=2 * np.abs(want).max() + 1e-9, err_msg=keystr(path))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_vlm_loss_with_vis_embeds_vs_reference():
    """The VLM stub input: the smoke ``internvl2_76b`` in float32 with
    ``vis_embeds`` prepended.  The loss covers the text positions only and
    matches the JAX ``loss_fn`` within 1e-5 relative (the reference reads
    4.891891; without the embeddings both read the text-only 4.859192)."""
    cfg, tcfg, jparams, model, _, _, _ = _setup("internvl2_76b")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    vis = rng.normal(size=(2, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    data = {"tokens": tokens, "labels": labels, "vis_embeds": vis}
    with jops.local_backend("xla"):
        jl, _ = j_loss_fn(jparams, cfg, {k: jnp.asarray(v) for k, v in data.items()},
                          JShardCtx(), None, False, False)
    assert float(jl) == pytest.approx(4.891891, rel=1e-6)
    tl, metrics, _ = value_and_grad(model, tcfg, {k: torch.from_numpy(v) for k, v in data.items()},
                                    SINGLE, False)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(metrics["loss"]) == pytest.approx(float(jl), rel=1e-5)


def test_microbatched_gradient_equals_full_batch_gradient():
    """Two microbatches of 2 rows average to the 4-row batch's gradient
    (every row has the same token count), within 1e-5 of each leaf's max."""
    cfg, tcfg, jparams, model, data, jrun, trun = _setup()
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    _, _, full = value_and_grad(model, tcfg, tbatch, SINGLE, False)
    halves = [value_and_grad(model, tcfg, {k: v[i:i + 2] for k, v in tbatch.items()}, SINGLE,
                             False)[2] for i in (0, 2)]
    for (path, g), (_, a), (_, b) in zip(tree_flatten(full), tree_flatten(halves[0]),
                                         tree_flatten(halves[1])):
        avg = ((a + b) / 2).numpy()
        np.testing.assert_allclose(avg, g.numpy(), rtol=0, atol=1e-5 * float(g.abs().max()),
                                   err_msg=keystr(path))


def test_adamw_on_shared_gradients_vs_reference():
    """Three AdamW steps, the same float32 params and gradients in both
    packages (matrices decayed, vectors not, clipping active): params and
    moments within 1e-6 relative of the reference's."""
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 5), "b": (5,), "blk": {"stack": (2, 4, 3), "scale": (3,)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.init_opt_state(params)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = topt.init_opt_state(tp)
    for step in range(3):
        grads = jax.tree.map(lambda p: rng.normal(0, 0.3, p.shape).astype(np.float32), params)
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp, jax.tree.map(jnp.asarray,
                                                                                  grads), js)
        tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**cfg), tp,
                                       jax.tree.map(torch.from_numpy, grads), ts)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
            for (path, g), (_, w) in zip(tree_flatten(got), tree_flatten(_jtree(want))):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                           err_msg=f"step {step} {keystr(path)}")
    assert int(ts["step"]) == int(js["step"]) == 3


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 10), (5, 5)])
def test_lr_schedule_vs_reference(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 3, warmup, warmup + 1, total // 2, total, total + 7):
        got = float(topt.lr_at(topt.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
        want = float(jopt.lr_at(jopt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_int8_compression_vs_reference_and_error_feedback():
    """quantise / dequantise exactly as the reference; with the error fed
    back, 64 steps of the same gradient average to it within 1e-3."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=256).astype(np.float32)
    g[:3] = [0.5, -0.5, 1.5]  # ties round to even in both
    tq, ts = topt.quantize_int8(torch.from_numpy(g))
    jq, js = jopt.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(topt.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jopt.dequantize_int8(jq, js)))
    err = torch.zeros(256)
    acc = torch.zeros(256)
    for _ in range(64):
        deq, err = topt.compress_with_feedback(torch.from_numpy(g), err)
        acc = acc + deq
    np.testing.assert_allclose((acc / 64).numpy(), g, atol=1e-3)


@pytest.mark.parametrize("spec", [dict(vocab=64, seq_len=32, batch=4, seed=3),
                                  dict(vocab=49_152, seq_len=128, batch=2, seed=0),
                                  dict(vocab=2048, seq_len=16, batch=2, n_codebooks=4)])
def test_batch_at_same_bytes_as_reference(spec):
    for step, rank in ((0, 0), (5, 0), (123, 3)):
        got, want = batch_at(SynthSpec(**spec), step, rank), j_batch_at(JSynth(**spec), step,
                                                                        rank)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_prefetch_loader_numpy_and_device():
    spec = dict(vocab=64, seq_len=16, batch=2)
    ref = JLoader(j_iter(JSynth(**spec)), depth=2)
    host = PrefetchLoader(make_iterator(SynthSpec(**spec)), depth=2)
    dev = PrefetchLoader(make_iterator(SynthSpec(**spec), start_step=1), depth=3, device="cpu")
    r = [next(ref) for _ in range(4)]
    for i in range(3):
        h, d = next(host), next(dev)
        np.testing.assert_array_equal(h["tokens"], r[i]["tokens"])
        assert isinstance(d["tokens"], torch.Tensor) and d["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(d["labels"].numpy(), r[i + 1]["labels"])
    for loader in (ref, host, dev):
        loader.close()


def test_train_loop_loss_decreases_and_init_is_master_weights():
    """The reference's loss-decrease check, on the CPU; the state is float32
    and requires grad."""
    cfg = get_smoke_config("smollm_360m")
    run = RunConfig(model=cfg, shape=ShapeConfig(**SHAPE), dp=1, tp=1, remat="none")
    model, state = init_train_state(cfg, run, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    stats = train_loop(cfg, run, SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=0),
                       total_steps=30, opt=topt.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                            total_steps=30),
                       log_every=1000, log_fn=lambda s: None, device="cpu")
    assert np.mean(stats.losses[-5:]) < np.mean(stats.losses[:5]) - 0.2, stats.losses


@pytest.mark.parametrize("slice_elems", [1, 17, 455])
def test_adamw_sliced_update_equals_whole_leaf_update(monkeypatch, slice_elems):
    """The update runs leaf by leaf in slices of ``UPDATE_SLICE`` elements
    (one slice's temporaries at a time); the arithmetic is elementwise, so
    params and moments equal a whole-leaf update's bit for bit over three
    steps, weight decay on the matrix only."""
    def run(elems):
        monkeypatch.setattr(topt, "UPDATE_SLICE", elems)
        gen = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(7, 13, 5, generator=gen), "b": torch.randn(11, generator=gen)}
        state = topt.init_opt_state(params)
        for _ in range(3):
            grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
            params, state, _ = topt.adamw_update(topt.AdamWConfig(warmup_steps=1), params,
                                                 grads, state)
        return params, state

    (wp, ws), (gp, gs) = run(1 << 24), run(slice_elems)
    for k in wp:
        assert torch.equal(gp[k], wp[k]) and torch.equal(gs["mu"][k], ws["mu"][k]) \
            and torch.equal(gs["nu"][k], ws["nu"][k]), k
