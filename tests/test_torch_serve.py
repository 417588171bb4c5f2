"""Opportunistic serving in the port, on the CPU: the smoke Mamba-2 behind
``OpportunisticServer``, mirroring the JAX package's serving test
(``tests/test_train_ckpt.py``): a speculatively prefilled prompt is served
faster than a cold one, and an identical resubmission is a cache hit.  Also:
the server's answers equal a direct greedy decode, its cache entries report
their true size, and it refuses the card when there is none."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import SINGLE, init_model
from repro_torch.serve import CacheResult, OpportunisticServer, greedy_generate, make_serve_fns


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("mamba2_2p7b")
    return cfg, init_model(cfg, seed=0, device="cpu")


def test_opportunistic_server_speculative_prefill(model):
    cfg, params = model
    srv = OpportunisticServer(cfg, params, step_cost_s=0.05, prefill_cost_s=0.1, device="cpu")
    prompt = tuple(range(1, 33))

    srv.request(prompt, n_tokens=4)  # cold: pays prefill + decode
    cold = srv.metrics.interactions[-1].latency_s

    nxt = tuple(range(2, 34))
    srv.anticipate(nxt)
    srv.think(10.0)  # think time warms its prefix cache
    warm_out = srv.request(nxt, n_tokens=4)
    warm = srv.metrics.interactions[-1].latency_s
    assert warm < cold

    again_out = srv.request(nxt, n_tokens=4)  # identical resubmission
    rec = srv.metrics.interactions[-1]
    assert rec.latency_s <= warm and rec.latency_s == 0.0 and rec.ops_executed == 0
    np.testing.assert_array_equal(again_out.tokens, warm_out.tokens)

    # the warm answer equals a cold greedy decode of the same prompt
    pre, dec, _ = make_serve_fns(cfg, SINGLE, capacity=256)
    direct = greedy_generate(cfg, params, pre, dec, torch.tensor([nxt]), 4)
    np.testing.assert_array_equal(warm_out.tokens, direct[0].numpy())


def test_cache_result_counts_every_tensor(model):
    cfg, params = model
    pre, _, _ = make_serve_fns(cfg, SINGLE)
    logits, cache = pre(params, torch.arange(1, 17)[None])
    res = CacheResult(logits, cache, 16)
    st = cache["groups"]["p0_ssd"]
    want = sum(t.numel() * t.element_size() for t in (logits, st.h, st.conv, st.pos))
    assert res.nbytes == want and st.h.shape[0] == cfg.n_layers


def test_server_and_model_refuse_the_card_without_one(model):
    cfg, params = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        OpportunisticServer(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg, seed=0)
