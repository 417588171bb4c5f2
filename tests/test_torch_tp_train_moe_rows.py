"""An MoE trained under tensor parallelism over more than one data row, on the
CPU, against the JAX package.

The reference's live trainer runs its MoE layers through the global
``moe_ffn`` (no ``use_ep``): the whole batch routed at one capacity, with one
pair of aux losses.  The port's step over ``make_mesh(2, 2)`` with the train
state in slices over the rows and the shards (TP × FSDP) does the same: the
batch stays whole on the first row's cards, the experts stay in their slices
over the shards, and the other row's slices are gathered there and take their
gradient back.  ``use_ep=True`` keeps the reference's expert-parallel
semantics: each row routes its half of the batch at its own capacity, and
the aux losses are the rows' mean.

The mesh is emulated by ``cpu:i`` devices (distinct cards, as
``test_torch_tp_train.py``'s ``CARDS``); inputs come from seeds through
numpy (the smoke ``granite_moe_3b_a800m`` in float32, the tests' batch of
4 x 32 tokens).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.base import ShardCtx as JShardCtx
from repro.train.trainstep import loss_fn as j_loss_fn
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.base import ShardCtx
from repro_torch.train.trainstep import value_and_grad
from test_torch_tp_train import (CARDS, GRAD_TOL, LOSS_REL, _cfgs, _close, _data, _placed,
                                 _reference, _torch, _whole)

ARCH = "granite_moe_3b_a800m"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after), as in
    ``test_torch_tp_train.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_step(jparams, tcfg, dp, data, use_ep=False):
    mesh = make_mesh(dp, 2, devices=CARDS[:2 * dp])
    model = _placed(jparams, tcfg, 2, mesh)
    return value_and_grad(model, tcfg, _torch(data), ShardCtx(tp=2), False, mesh, use_ep)


def test_tp_moe_step_over_two_rows_routes_the_whole_batch_as_the_reference():
    """The step over ``(2, 2)`` against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` at ``ShardCtx(tp=2, dp=2)`` (no ``use_ep``, as its
    trainer calls it): the total and the loss within 1e-6 relative, each
    aux loss within 1e-6 relative, every gradient leaf within 1e-4 of its
    largest |g|."""
    cfg, tcfg = _cfgs(ARCH)
    jparams = _reference(cfg, 2)
    data = _data(cfg)
    with jops.local_backend("xla"):
        (jl, jm), jg = jax.value_and_grad(
            lambda p: j_loss_fn(p, cfg, {k: jnp.asarray(v) for k, v in data.items()},
                                JShardCtx(tp=2, dp=2), None, False, False),
            has_aux=True)(jparams)
    tl, tm, grads = _port_step(jparams, tcfg, 2, data)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_REL)
    assert set(tm) == set(jm) and "moe_aux" in tm
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_REL), k
    _close(_whole(grads), jax.tree.map(np.asarray, jg), GRAD_TOL, "grad")


def test_use_ep_still_routes_each_row_at_its_own_capacity():
    """``use_ep=True`` over ``(2, 2)``: each row routes its half of the batch
    on its own, so the aux losses are the mean of the two halves' steps over
    ``(1, 2)`` (each half routed whole), within 1e-6 relative, and differ
    from the whole-batch route's by more than that."""
    cfg, tcfg = _cfgs(ARCH)
    jparams = _reference(cfg, 2)
    data = _data(cfg)
    _, ep, _ = _port_step(jparams, tcfg, 2, data, use_ep=True)
    _, whole, _ = _port_step(jparams, tcfg, 2, data)
    halves = [_port_step(jparams, tcfg, 1, {k: v[r * 2:(r + 1) * 2] for k, v in data.items()})[1]
              for r in range(2)]
    for k in ("moe_aux", "moe_z"):
        mean = (float(halves[0][k]) + float(halves[1][k])) / 2
        assert float(ep[k]) == pytest.approx(mean, rel=LOSS_REL), k
    assert abs(float(ep["moe_aux"]) - float(whole["moe_aux"])) > LOSS_REL * abs(
        float(whole["moe_aux"]))
