"""The port's launchers (``python -m repro_torch.launch.train`` / ``serve``)
against the JAX package's, on the CPU.

``launch.train.main`` builds the same ShapeConfig, RunConfig, SynthSpec and
AdamWConfig, and hands ``train_loop`` the same arguments, as
``src/repro/launch/train.py:43-61`` does from the same flags (both loops
replaced by a recorder); smoke runs of granite-MoE and smollm train with
finite, falling losses; ``--fail-at-step`` with ``--ckpt-dir`` resumes from
the checkpoint written on exit (ROADMAP C4) and ends on the uninterrupted
run's loss; a mesh (``--dp``/``--tp``/``--pods`` > 1) is refused with a
message naming ROADMAP A7.  ``launch.serve.main`` serving the JAX launcher's
weights (``params_from_numpy``) gives the reference's tokens and simulated
latencies, equal.
"""
import dataclasses
import io
import math
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

import repro.launch.serve as jserve
import repro.launch.train as jtrain
import repro.serve.session as jsession
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import params_from_numpy
from repro_torch.train import LoopStats


def _quiet(fn, *args, **kwargs):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _fields(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def _captured_loop(monkeypatch, module, stats):
    seen = {}

    def loop(cfg, run, data, **kwargs):
        seen.update(cfg=cfg, run=run, data=data, **kwargs)
        return stats

    monkeypatch.setattr(module, "train_loop", loop)
    return seen


FLAG_SETS = [
    ["--arch", "smollm_360m"],
    ["--arch", "granite_moe_3b_a800m", "--steps", "7", "--batch", "4", "--seq", "64", "--lr",
     "1e-3", "--microbatch", "2", "--remat", "full", "--grad-compression", "--seed", "3",
     "--ckpt-dir", "ckpts", "--ckpt-every", "3", "--fail-at-step", "5"],
    ["--arch", "granite_moe_3b_a800m", "--full-config", "--steps", "4", "--batch", "8",
     "--seq", "4096", "--microbatch", "4", "--remat", "full", "--seed", "12"],
    ["--arch", "musicgen_large", "--steps", "50", "--batch", "2"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["defaults", "every-flag", "granite-full",
                                                  "codebooks"])
def test_train_builds_the_references_configs(monkeypatch, flags):
    stats = LoopStats(steps=1, losses=[1.0])
    want = _captured_loop(monkeypatch, jtrain, stats)
    monkeypatch.setattr(sys, "argv", ["train", *flags])
    _quiet(jtrain.main)
    got = _captured_loop(monkeypatch, ttrain, stats)
    assert _quiet(ttrain.main, [*flags, "--device", "cpu"]) is stats

    assert want.pop("mesh") is None
    assert got.pop("device") == "cpu"
    assert set(got) == set(want)
    for key in want:
        assert _fields(got[key]) == _fields(want[key]), key


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "smollm_360m"])
def test_train_smoke_run_losses_finite_and_falling(arch):
    stats = _quiet(ttrain.main, ["--arch", arch, "--steps", "3", "--device", "cpu"])
    assert stats.steps == 3 and len(stats.losses) == 3
    assert all(math.isfinite(x) for x in stats.losses + stats.grad_norms)
    assert stats.losses[-1] < stats.losses[0]


def test_train_fail_at_step_resumes_from_the_exit_checkpoint(tmp_path):
    base = ["--arch", "smollm_360m", "--steps", "4", "--batch", "2", "--seq", "32",
            "--ckpt-every", "2", "--device", "cpu"]
    whole = _quiet(ttrain.main, [*base, "--ckpt-dir", str(tmp_path / "whole")])
    with pytest.raises(RuntimeError, match="injected node failure at step 3"):
        _quiet(ttrain.main, [*base, "--ckpt-dir", str(tmp_path / "cut"), "--fail-at-step", "3"])
    resumed = _quiet(ttrain.main, [*base, "--ckpt-dir", str(tmp_path / "cut")])
    # the loop saves on exit, so the rerun starts at step 3, not at the
    # step-2 checkpoint (ROADMAP C4)
    assert resumed.resumed_from == 3 and resumed.steps == 1
    assert resumed.losses == whole.losses[3:]


@pytest.mark.parametrize("flag", ["--dp", "--tp", "--pods"])
def test_train_refuses_a_mesh_naming_a7(capsys, flag):
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--arch", "smollm_360m", flag, "2", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP A7" in err and "mesh of 2 devices" in err


def test_serve_launcher_vs_reference(monkeypatch):
    """Three requests of three tokens: tokens and simulated latencies equal
    the reference launcher's on the same weights and prompts."""
    flags = ["--requests", "3", "--tokens", "3"]
    made, outs = [], []
    init_model = jserve.init_model
    request = jsession.OpportunisticServer.request

    def keep_params(*args, **kwargs):
        made.append(init_model(*args, **kwargs))
        return made[-1]

    def recording(self, *args, **kwargs):
        out = request(self, *args, **kwargs)
        outs.append((np.asarray(out.tokens).tolist(), self.metrics.interactions[-1].latency_s))
        return out

    monkeypatch.setattr(jserve, "init_model", keep_params)
    monkeypatch.setattr(jsession.OpportunisticServer, "request", recording)
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    _quiet(jserve.main)

    cfg = get_smoke_config("qwen3_8b")
    params = params_from_numpy(jax.tree.map(np.asarray, made[0]), cfg, device="cpu")
    monkeypatch.setattr(tserve, "init_model", lambda *args, **kwargs: params)
    got = _quiet(tserve.main, [*flags, "--device", "cpu"])
    assert [(r["tokens"], r["latency_s"]) for r in got] == outs
    assert len(got) == 3 and all(len(r["tokens"]) == 3 for r in got)
