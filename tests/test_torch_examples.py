"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``), both run in-process on the CPU.

Each port example's ``main(["--device", "cpu"])`` runs the JAX example's
program.  Dataframe answers agree under the parity tolerances of
``tests/test_backend_parity.py:51-54`` (count exact, mean rtol 1e-4 /
atol 1e-5, std rtol 1e-3 / atol 1e-4, min and max rtol 1e-5; group means
as means); everything else (columns, head rows, tokens) is exact.  The
simulated latencies come from the engine's virtual clock and cost model
alone, so they are equal too.  The LM examples get the JAX example's
weights carried over (``params_from_numpy``): the served tokens are equal,
and the training losses agree within the limit stated at
``test_train_lm_example_vs_reference``; its step times are measured wall
time and are not compared.  The JAX dataframe examples run the numpy
backend (their default) and the port's the plain PyTorch versions at the
engine's tier, which engages the planner; cache hit counts follow that
tier, so they are not compared.
"""
import importlib.util
import io
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.frame.api as japi
import repro.serve.session as jsession
import repro_torch.frame.api as tapi
from repro.configs import get_smoke_config as j_smoke
from repro.models import ShardCtx as JShardCtx
from repro.models import init_model as j_init_model
from repro_torch.configs import get_smoke_config
from repro_torch.models import params_from_numpy
from repro_torch.train import loop as tloop
from repro_torch.train.optimizer import init_opt_state

ROOT = Path(__file__).resolve().parents[1]
STAT_TOL = {"count": (0.0, 0.0), "mean": (1e-4, 1e-5), "std": (1e-3, 1e-4),
            "min": (1e-5, 0.0), "max": (1e-5, 0.0)}
MEAN_TOL = STAT_TOL["mean"]


def _port_example(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}", ROOT / "examples" /
                                                  f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kwargs):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _record_cells(monkeypatch, cls):
    """Every ``Session.cell`` call of ``cls`` as (code, answer)."""
    seen = []
    cell = cls.cell

    def recording(self, code):
        out = cell(self, code)
        seen.append((code, out))
        return out

    monkeypatch.setattr(cls, "cell", recording)
    return seen


def _run_jax_example(monkeypatch, name):
    monkeypatch.setattr(sys, "path", list(sys.path))  # the example inserts "src"
    return _quiet(runpy.run_path, str(ROOT / "examples" / f"{name}.py"))


def _as_plain(answer):
    return answer.to_pydict() if hasattr(answer, "to_pydict") else list(answer)


def _assert_answer(got, want, code):
    got, want = _as_plain(got), _as_plain(want)
    if isinstance(want, list):
        assert got == want, code
        return
    assert list(got) == list(want), code
    stats = want.get("stat")
    for col, w in want.items():
        g = got[col]
        assert g.shape == w.shape, (code, col)
        if w.dtype.kind in "OUS":
            np.testing.assert_array_equal(g, w, err_msg=f"{code}/{col}")
        elif stats is not None:
            for i, stat in enumerate(stats):
                rtol, atol = STAT_TOL[stat]
                np.testing.assert_allclose(float(g[i]), float(w[i]), rtol=rtol, atol=atol,
                                           err_msg=f"{code}/{col}/{stat}")
        elif ".mean()" in code:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=MEAN_TOL[0], atol=MEAN_TOL[1],
                                       err_msg=f"{code}/{col}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{code}/{col}")


def _latencies(session):
    return [r.latency_s for r in session.engine.metrics.interactions]


@pytest.mark.parametrize("name,n_answers", [("quickstart", 2), ("interactive_session", 8)])
def test_dataframe_example_vs_reference(monkeypatch, name, n_answers):
    jcells = _record_cells(monkeypatch, japi.Session)
    jglobals = _run_jax_example(monkeypatch, name)
    tcells = _record_cells(monkeypatch, tapi.Session)
    got = _quiet(_port_example(name).main, ["--device", "cpu"])

    assert [c for c, _ in tcells] == [c for c, _ in jcells]
    shown = [(c, a) for c, a in tcells if a is not None]
    assert len(shown) == n_answers == len(got["answers"])
    assert all(a is b for (_, a), b in zip(shown, got["answers"]))
    want = [a for _, a in jcells if a is not None]
    for (code, g), w in zip(shown, want):
        _assert_answer(g, w, code)
    # the simulated clock alone sets the latencies: equal, not close
    assert _latencies(got["session"]) == _latencies(jglobals["session"])
    assert got["latencies"] == _latencies(got["session"])
    want_metrics = jglobals["session"].engine.metrics.summary()
    assert got["session"].engine.metrics.summary() == want_metrics
    if name == "interactive_session":
        assert got["speculation_hits"] == jglobals["session"].engine.speculation.hits == 2


def test_serve_example_vs_reference(monkeypatch):
    """The JAX example's weights served by the port: the three requests'
    tokens and simulated latencies equal."""
    jtokens = []
    request = jsession.OpportunisticServer.request

    def recording(self, *args, **kwargs):
        out = request(self, *args, **kwargs)
        jtokens.append(np.asarray(out.tokens).tolist())
        return out

    monkeypatch.setattr(jsession.OpportunisticServer, "request", recording)
    jglobals = _run_jax_example(monkeypatch, "serve_opportunistic")
    cfg = get_smoke_config("qwen3_8b")
    params = params_from_numpy(jax.tree.map(np.asarray, jglobals["params"]), cfg, device="cpu")
    example = _port_example("serve_opportunistic")
    monkeypatch.setattr(example, "init_model", lambda *args, **kwargs: params)
    got = _quiet(example.main, ["--device", "cpu"])
    assert got["tokens"] == jtokens
    server = jglobals["server"]
    assert got["latencies"] == [r.latency_s for r in server.metrics.interactions]
    assert got["metrics"] == server.metrics.summary()


def test_train_lm_example_vs_reference(monkeypatch, tmp_path):
    """Three steps of the smoke smollm (bf16 compute, float32 master
    weights) from the JAX example's initial weights: the losses agree
    within 1e-4 relative (the two packages round bf16 products and sums in
    other orders; they read about 6e-6 apart) and fall; each run writes
    its checkpoint on exit."""
    argv = ["--steps", "3", "--ckpt-dir"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv, str(tmp_path / "jax")])
    jmod = _quiet(runpy.run_path, str(ROOT / "examples" / "train_lm.py"))
    jlosses = []
    jloop = sys.modules["repro.train.loop"]
    train_loop = jloop.train_loop

    def recording(*args, **kwargs):
        stats = train_loop(*args, **kwargs)
        jlosses.extend(stats.losses)
        return stats

    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setitem(jmod["main"].__globals__, "train_loop", recording)
    _quiet(jmod["main"])

    jcfg, cfg = j_smoke("smollm_360m"), get_smoke_config("smollm_360m")
    jparams = jax.tree.map(np.asarray, j_init_model(jcfg, JShardCtx(), seed=0))

    def init_from_jax(cfg_, run, ctx, seed, device):
        assert seed == 0
        model = params_from_numpy(jparams, cfg, device=device, trainable=True)
        return model, init_opt_state(model.tree())

    monkeypatch.setattr(tloop, "init_train_state", init_from_jax)
    stats = _quiet(_port_example("train_lm").main,
                   [*argv, str(tmp_path / "torch"), "--device", "cpu"])
    assert stats.steps == len(jlosses) == 3
    np.testing.assert_allclose(stats.losses, jlosses, rtol=1e-4, atol=0)
    assert stats.losses[-1] < stats.losses[0]
    assert (tmp_path / "torch" / "step_00000003").is_dir()
    assert (tmp_path / "jax" / "step_00000003").is_dir()
