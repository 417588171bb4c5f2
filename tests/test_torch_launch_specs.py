"""The port's input specs (``repro_torch.launch.specs``) beside the JAX
package's ``tests/test_launch_specs.py``: the batch and the decode cache of
every config, leaf by leaf, placed as the reference's ``PartitionSpec``s at
``ShardCtx(tp=16, dp=16)`` (and over two pods), the ``vis_embeds`` stub,
codebooks, the replicated batch-1 decode of ``long_500k``, and the cell
registry.  Every stand-in is a ``meta`` tensor: nothing is allocated."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as r_config
from repro.launch import specs as r_specs
from repro.models.base import ShardCtx as RCtx
from repro_torch.configs import ARCH_IDS, all_cells, get_config, get_shape
from repro_torch.launch import specs
from repro_torch.models.base import ShardCtx

CTX = ShardCtx(tp=16, dp=16)
R_CTX = RCtx(tp=16, dp=16)
PODS = ShardCtx(tp=16, dp=16, pods=2, data_axes=("pod", "data"))
R_PODS = RCtx(tp=16, dp=16, pods=2, data_axes=("pod", "data"))
DECODE_CELLS = [(a, s) for a, s in all_cells() if get_shape(s).kind == "decode"]


def _ref_leaves(tree):
    """[(path, shape, placement)] of a reference cache tree and its specs,
    the path of dict keys and field names as the port's ``cache_leaves``."""
    shapes, specs_ = tree
    out = []
    flat_s = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_p = jax.tree.leaves(specs_, is_leaf=lambda x: isinstance(x, P))
    for (path, leaf), spec in zip(flat_s, flat_p):
        names = tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)
        out.append((names, tuple(leaf.shape), tuple(spec)))
    return out


def _port_leaves(cache, cache_specs):
    """[(path, shape, placement)] of a port cache tree and its specs tree
    (the same tree with placement tuples for tensors)."""
    placed = dict(specs.cache_leaves(cache_specs))
    return [(path, tuple(t.shape), placed[path]) for path, t in specs.cache_leaves(cache)]


def test_all_cells_skips_long500k_for_quadratic_archs():
    cells = all_cells()
    assert len(cells) == 33  # 10 x 3 + 3 sub-quadratic long_500k
    assert {a for a, s in cells if s == "long_500k"} == {
        "h2o_danube_3_4b", "recurrentgemma_9b", "mamba2_2p7b"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_specs_equal_reference(arch):
    """Shapes, types and placements of the batch, at one pod and at two."""
    cfg, shape = get_config(arch), get_shape("train_4k")
    for ctx, r_ctx in ((CTX, R_CTX), (PODS, R_PODS)):
        shapes, placed = specs.train_input_specs(cfg, shape, ctx)
        r_shapes, r_placed = r_specs.train_input_specs(r_config(arch), shape, r_ctx)
        assert set(shapes) == set(r_shapes)
        for k in shapes:
            assert shapes[k].device.type == "meta"
            assert tuple(shapes[k].shape) == tuple(r_shapes[k].shape), k
            assert str(shapes[k].dtype).split(".")[-1] == str(r_shapes[k].dtype), k
            assert placed[k] == tuple(r_placed[k]), k
        assert placed["tokens"][0] == ctx.data_spec()
        assert shapes["tokens"].shape[0] == shape.global_batch


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).n_vis_tokens
                                  or get_config(a).n_codebooks > 1])
def test_vis_stub_and_codebooks(arch):
    cfg, shape = get_config(arch), get_shape("train_4k")
    shapes, placed = specs.train_input_specs(cfg, shape, CTX)
    if cfg.n_vis_tokens:
        assert tuple(shapes["vis_embeds"].shape) == (shape.global_batch, cfg.n_vis_tokens,
                                                     cfg.d_model)
        assert shapes["vis_embeds"].dtype == torch.bfloat16
        assert placed["vis_embeds"] == ("data", None, None)
    if cfg.n_codebooks > 1:
        assert tuple(shapes["tokens"].shape) == (shape.global_batch, cfg.n_codebooks,
                                                 shape.seq_len)
        assert placed["tokens"] == ("data", None, None)


@pytest.mark.parametrize("arch,shape_name", DECODE_CELLS)
def test_decode_cache_specs_equal_reference(arch, shape_name):
    """Every cache leaf: same path, shape and placement as the reference's
    ``decode_input_specs`` (its ``make_cache_specs`` keyed by tree path)."""
    cfg, shape = get_config(arch), get_shape(shape_name)
    shapes, placed = specs.decode_input_specs(cfg, shape, CTX)
    r_shapes, r_placed = r_specs.decode_input_specs(r_config(arch), shape, R_CTX)
    assert placed["tokens"] == tuple(r_placed["tokens"])
    assert placed["pos"] == tuple(r_placed["pos"]) == ()
    ours = _port_leaves(shapes["cache"], placed["cache"])
    theirs = _ref_leaves((r_shapes["cache"], r_placed["cache"]))
    assert sorted(ours) == sorted(theirs)  # JAX flattens a dict's keys sorted
    for _, t in specs.cache_leaves(shapes["cache"]):
        assert t.device.type == "meta"


@pytest.mark.parametrize("arch", ["qwen3_8b", "mamba2_2p7b", "recurrentgemma_9b"])
def test_decode_cache_specs_leafwise_valid(arch):
    """Every cache leaf's placement has its rank; sharded dims divide evenly
    on the 16 x 16 mesh."""
    cfg, shape = get_config(arch), get_shape("decode_32k")
    shapes, placed = specs.decode_input_specs(cfg, shape, CTX)
    leaves = _port_leaves(shapes["cache"], placed["cache"])
    assert leaves
    for _, dims, spec in leaves:
        assert len(spec) == len(dims)
        for dim, ax in zip(dims, spec):
            if ax is not None:
                assert dim % 16 == 0, (arch, dims, spec)


def test_long500k_batch1_replicated():
    cfg = get_config("mamba2_2p7b")
    shapes, placed = specs.decode_input_specs(cfg, get_shape("long_500k"), CTX)
    assert placed["tokens"][0] is None  # batch 1 cannot be split
    for _, _, spec in _port_leaves(shapes["cache"], placed["cache"]):
        assert "data" not in spec


def test_registry_aliases_resolve():
    for alias in ("qwen3-moe-30b-a3b", "mamba2-2.7b", "h2o-danube-3-4b"):
        assert get_config(alias).name == alias
