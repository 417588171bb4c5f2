"""Each cell's comparison, driven on the CPU at a small size through its
own kind module: a sound run comes out correct; the control (the plain reference
at the precision below the configuration's, in the program's place) and
each fault that the cell can have, planted in the timed path, come out not
correct."""
import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent / "src"))

from harness import small  # noqa: E402

# each cell, and the notebook under the mix with think time (``explore``)
CELLS = (("tpch_sf1.run_all", "explore"), ("tpch_sf1.run_all", ""),
         ("mamba2_2p7b.train_4k", ""), ("mamba2_2p7b.assist", ""))


def _run(name, seconds=1.0, traffic=""):
    cell = small.small_cell(name, traffic)
    return small.kind_of(cell).run(cell, seed=2**31 + 7, seconds=seconds, trace=False,
                                  device="cpu")


@pytest.mark.parametrize("name,traffic", CELLS)
def test_a_sound_run_is_correct(name, traffic):
    out = _run(name, traffic=traffic)
    assert out.attempted > 0 and out.failed == 0
    assert out.correct, out.checks


@pytest.mark.parametrize("name", ("tpch_sf1.run_all", "mamba2_2p7b.train_4k"))
def test_the_control_is_not_correct(name):
    cell = small.small_cell(name)
    kind = small.kind_of(cell)
    control = kind.control(cell, 3, device="cpu")[kind.CONTROL]
    assert any(v > lim for v, lim in control.values()), control


def test_the_served_models_control_reads_apart_from_the_program():
    """The served model's gap grows with depth and width: at the cell's
    size on the card the control reads past the limit; at a size that a
    test holds, 32 layers of width 256, it reads ten times the sound
    program's gap or more."""
    cell = small.small_cell("mamba2_2p7b.assist", d_model=256, n_layer=32, vocab_size=2048,
                            d_state=32, headdim=32)
    cell.traffic["n_tokens"] = 16
    kind = small.kind_of(cell)
    sound = kind.run(cell, seed=2, seconds=1.0, trace=False, device="cpu").checks
    control = kind.control(cell, 2, device="cpu")[kind.CONTROL]
    assert control["token_gap"][0] > 10 * max(sound["token_gap"][0], 0.01), (sound, control)


def test_an_altered_answer_is_not_correct(monkeypatch):
    from repro_torch.frame import api
    from repro_torch.frame.table import Column

    real = api.Session.show

    class Altered:
        def __init__(self, value):
            self.value = value

        def concat(self):
            p = self.value.concat()
            name = p.order[-1]
            col = p.columns[name]
            data = np.array(col.data, copy=True)
            data[: max(1, len(data) // 2)] += 1
            p.columns[name] = Column(data=data, mask=col.mask, dictionary=col.dictionary)
            return p

    def show(self, x):
        value = real(self, x)
        return list(value)[::-1] if not hasattr(value, "concat") else Altered(value)

    monkeypatch.setattr(api.Session, "show", show)
    out = _run("tpch_sf1.run_all", traffic="explore")
    assert not out.correct and out.checks["exact_mismatches"][0] > 0, out.checks


def _train_with(monkeypatch, fault):
    from repro_torch.train import trainstep

    real = trainstep.make_train_step

    def make(*args, **kw):
        step, rest = real(*args, **kw)
        return (lambda model, opt, batch: fault(step, model, opt, batch)), rest

    monkeypatch.setattr(trainstep, "make_train_step", make)
    return _run("mamba2_2p7b.train_4k")


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    def unchanged(step, model, opt, batch):
        _, _, met = step(copy.deepcopy(model), copy.deepcopy(opt), batch)
        return model, opt, met

    out = _train_with(monkeypatch, unchanged)
    assert not out.correct and out.checks["change_gap"][0] > out.checks["change_gap"][1]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    def half(step, model, opt, batch):
        n = batch["tokens"].shape[1] // 2
        return step(model, opt, {k: v[:, :n] for k, v in batch.items()})

    out = _train_with(monkeypatch, half)
    assert not out.correct, out.checks


def test_an_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serve import session

    real = session.OpportunisticServer.request

    def request(self, prompt, n_tokens=8, **kw):
        toks = np.array(real(self, prompt, n_tokens=n_tokens, **kw).tokens, copy=True)
        toks[-1] = (toks[-1] + 1) % small.SMALL_MODEL["vocab_size"]
        return SimpleNamespace(tokens=toks)

    monkeypatch.setattr(session.OpportunisticServer, "request", request)
    out = _run("mamba2_2p7b.assist")
    assert not out.correct, out.checks
