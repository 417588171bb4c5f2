"""The benchmark's arithmetic against hand-computed values: percentiles,
unions of device intervals and idle gaps, the bounds behind the
rooflines, the parameter count behind the MFU, and the metric readers that
combine them."""
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import arith, mamba_ref, spec  # noqa: E402
from harness.trace import DeviceTrace, Span  # noqa: E402


def test_percentile_interpolates_between_order_statistics():
    xs = [10.0, 20.0, 30.0, 40.0, 50.0]
    assert arith.percentile(xs, 0) == 10.0
    assert arith.percentile(xs, 50) == 30.0
    assert arith.percentile(xs, 90) == pytest.approx(46.0)  # 4 * 0.9 = 3.6: 40 + 0.6 * 10
    assert arith.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        arith.percentile([], 50)


def test_union_counts_overlaps_once_and_clips_to_the_window():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert arith.union_length(iv) == pytest.approx(4.0)
    assert arith.union_length(iv, 1.5, 5.5) == pytest.approx(1.5 + 0.5)
    assert arith.union_length([]) == 0.0
    assert arith.gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert arith.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert arith.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert arith.bound_s(3.35e9, 989e12) == pytest.approx(1.0)


def test_ssd_forward_need_by_hand():
    # one chunk of L = S = 2 tokens, H = P = N = 1, bf16 operands
    nbytes, flops = arith.ssd_forward_need(2, 1, 1, 1, 2)
    assert nbytes == 2 * (2 * 2 + 2 * 2) + 4 * 2 + 4  # x, y, B, C; log a; the state
    intra = 2 * (3 * 1 + 3 * 1 + 1 * 2 * 1)  # tri = 3
    inter = 2 * 1 * 1 * (2 * 1 + 1 * 1 + 2)
    assert flops == intra + inter
    # a ragged tail is charged as a whole chunk
    assert arith.ssd_forward_need(3, 1, 1, 1, 2)[1] == arith.ssd_forward_need(4, 1, 1, 1, 2)[1]


def test_mamba2_parameter_count_by_hand():
    m = dict(d_model=4, n_layer=2, vocab_size=10, expand=2, d_state=3, headdim=2, d_conv=4,
             tie_embeddings=False)
    di, nh = 8, 4
    per_layer = 4 * (2 * di + 2 * 3 + nh) + di * 4 + di * 4 + 2 * 4
    assert arith.mamba2_params(m) == 2 * 10 * 4 + 2 * per_layer
    # tied, over the vocabulary padded to a multiple of 16: one table of 16 rows
    tied = dict(m, tie_embeddings=True, pad_vocab_size_multiple=16)
    assert arith.mamba2_params(tied) == 16 * 4 + 2 * per_layer
    full = spec.cell("mamba2_2p7b.train_4k", spec.load_benchmark()).config["model"]
    assert 2.6e9 < arith.mamba2_params(full) < 2.9e9  # "2.7B"


def _outcome(spans, device, window=(0.0, 10.0), **data):
    rec = SimpleNamespace(spans=spans, window=window,
                          device_trace=DeviceTrace(window=window, device=device,
                                                   spans=[(s.kind, s.index, s.t0, s.t1)
                                                          for s in spans]))
    rec.of = lambda kind: [s for s in spans if s.kind == kind]
    cfg = spec.cell("mamba2_2p7b.train_4k", spec.load_benchmark()).config
    return SimpleNamespace(rec=rec, data=data, config=cfg, setup_s=1.0)


def test_readers_of_idle_share_mfu_and_roofline_by_hand():
    steps = [Span("step", 0, 0.0, 4.0, {"tokens": 4096}), Span("step", 1, 4.0, 8.0,
                                                               {"tokens": 4096})]
    dev = [("ssd_chunk_fwd", 0.0, 1.0, "kernel"), ("gemm", 0.5, 3.0, "kernel"),
           ("Memcpy HtoD", 6.0, 7.0, "copy"), ("ssd_bwd_dx", 7.0, 8.0, "kernel")]
    out = _outcome(steps, dev, params=1e9, seq=4096)
    idle = spec.metric_reader("idle_share.train").read(out)
    assert idle == pytest.approx(100.0 * (1 - 5.0 / 10.0))
    mfu = spec.metric_reader("mfu.train").read(out)
    assert mfu == pytest.approx(100.0 * 6 * 1e9 * 2 * 4096 / (10.0 * 989e12))
    dm = mamba_ref.dims(out.config["model"])
    need = 2 * dm.layers * (
        arith.bound_s(*arith.ssd_forward_need(4096, dm.heads, dm.p, dm.n, dm.chunk))
        + arith.bound_s(*arith.ssd_bwd_total(1, 4096, dm.heads, dm.p, dm.n, dm.chunk, 2,
                                             dh=False)))
    roof = spec.metric_reader("ssd_roofline.train").read(out)
    assert roof == pytest.approx(100.0 * need / 2.0)  # two seconds of ssd_ kernels
    tokens_per_s = spec.metric_reader("train_tokens_per_s").read(out)
    assert tokens_per_s == pytest.approx(2 * 4096 / 10.0)


def test_readers_of_the_notebook_by_hand():
    inter = [Span("interaction", 0, 0.0, 2.0, {"hit": True}),
             Span("think", 1, 2.0, 3.0, {}),
             Span("interaction", 2, 3.0, 4.0, {"hit": False})]
    dev = [("stats_tiles_kernel", 0.5, 1.0, "kernel"), ("other", 1.0, 1.5, "kernel"),
           ("topk_merge", 2.2, 2.4, "kernel"), ("Memcpy DtoH", 3.5, 3.75, "copy")]
    out = _outcome(inter, dev)
    read = lambda n: spec.metric_reader(n).read(out)  # noqa: E731
    assert read("interaction_mean_ms") == pytest.approx(1500.0)
    assert read("think_hit_share.nb") == pytest.approx(50.0)
    assert read("interaction_p90_ms.nb") == pytest.approx(1000.0 + 0.9 * 1000.0)
    # the topk kernel ran in think time, outside every interaction
    assert read("df_kernel_ms_per_interaction.nb") == pytest.approx(1e3 * 0.5 / 2)
    assert read("host_ms_per_interaction.nb") == pytest.approx(1e3 * (3.0 - 1.25) / 2)
    assert read("idle_share.nb") == pytest.approx(100.0 * (1 - 1.45 / 10.0))


def test_readers_that_find_nothing_return_nothing():
    out = _outcome([Span("request", 0, 0.0, 1.0, {"hit": False, "length": 100,
                                                  "n_tokens": 8})], [], params=1e9)
    assert spec.metric_reader("hit_request_ms.serve").read(out) is None
    assert spec.metric_reader("ssd_roofline.serve").read(out) is None
    assert spec.metric_reader("request_mean_ms").read(out) == pytest.approx(1000.0)
    assert math.isfinite(spec.metric_reader("mfu.serve").read(out))
