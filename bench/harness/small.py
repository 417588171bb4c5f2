"""Cells cut to a size that the CPU tests can run: the same files, traffic
and kinds, with the tables or the model shrunk.  Nothing here is
measured."""
from __future__ import annotations

import copy
import json

from . import spec

SMALL_MODEL = dict(d_model=512, n_layer=2, vocab_size=4096, d_state=64, headdim=64, chunk_size=16)


def small_cell(name: str, traffic: str = "", **model) -> spec.Cell:
    """The cell ``name`` at a small size, under the mix ``traffic`` where
    one is named (a mix no cell runs yet); ``model`` overrides the small
    model's sizes."""
    cell = spec.cell(name, spec.load_benchmark())
    cfg, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if traffic:
        t = json.loads((spec.BENCH / "traffic" / f"{traffic}.json").read_text())
    if "model" in cfg:
        cfg["model"].update(SMALL_MODEL, **model)
        if t["kind"] == "train":
            t["seq_len"] = 64
        else:
            t.update(prompt_len=[20, 70], n_tokens=4, control_seconds=1)
    else:
        cfg["tables"]["orders"]["rows"] = 5000
        cfg["tables"]["lineitem"]["rows"] = 20000
        cfg["comment_dictionary"] = 64
        t["control_answers"] = 24
    cell.config, cell.traffic = cfg, t
    return cell


def kind_of(cell: spec.Cell):
    return spec.kind_module(cell.traffic["kind"])
