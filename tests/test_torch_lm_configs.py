"""The LM configs and the registry (``repro_torch.configs``), the LM data
pipeline (``data.lm_data``) and the LM sharding rules on real parameter
trees (``dist.sharding.lm_params_sharding``), against the reference, on
the CPU.

Counts are exact: for the five full configs ``param_count``,
``active_param_count``, ``padded_vocab``, ``layer_locality`` and
``cache_memory_bytes`` equal the reference's, and the port's
``abstract_params`` (meta tensors: nothing allocated) hold
``param_count`` parameters plus the embedding's padded rows.  The port's
``ARCHS``, ``ASSIGNED`` and ``cells()`` equal the reference's, ``schnet``
included.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as R_CFG  # noqa: E402
from repro.configs import base as R_BASE  # noqa: E402
from repro.dist import sharding as RSH  # noqa: E402
from repro.models import transformer as R_TF  # noqa: E402
from repro.quantized import qkv_cache as R_QC  # noqa: E402
from repro_torch import configs as T_CFG  # noqa: E402
from repro_torch.configs import base as T_BASE  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.models import transformer as T_TF  # noqa: E402
from repro_torch.quantized import qkv_cache as T_QC  # noqa: E402

LM_ARCHS = ["gemma-2b", "gemma2-9b", "minicpm-2b", "llama4-scout-17b-16e",
            "llama4-maverick-400b-17b"]


# The reference's LMConfig field that the port does not have:
# ``quantized_kv`` is set and read by nothing (the int8 cache is chosen by
# calling ``decode_step_q8``).
REF_ONLY_FIELDS = {"quantized_kv"}


def _asdict(cfg):
    d = dataclasses.asdict(cfg)
    if d.get("moe") is not None:
        d["moe"] = dict(d["moe"])
    return d


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("which", ["config", "reduced_config"])
def test_lm_configs_equal_the_reference_field_for_field(arch, which):
    ref, port = R_CFG.get(arch), T_CFG.get(arch)
    want = _asdict(getattr(ref, which)())
    assert set(want) - set(_asdict(getattr(port, which)())) == REF_ONLY_FIELDS
    for name in REF_ONLY_FIELDS:
        del want[name]
    assert _asdict(getattr(port, which)()) == want
    for attr in ("ARCH_ID", "FAMILY", "SKIP", "SHAPES"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for attr in ("TRAIN_MICROBATCHES", "OPTIMIZER_SCHEDULE"):
        assert getattr(port, attr, None) == getattr(ref, attr, None), attr


def test_shape_tables_equal_the_reference():
    assert T_BASE.LM_SHAPES == R_BASE.LM_SHAPES
    assert T_BASE.GNN_SHAPES == R_BASE.GNN_SHAPES
    assert T_BASE.RECSYS_SHAPES == R_BASE.RECSYS_SHAPES
    assert T_BASE.CRITEO_VOCABS == R_BASE.CRITEO_VOCABS


def test_assigned_is_the_reference_minus_schnet():
    """Since the GNN slice the registry is the reference's whole: the same
    ``ASSIGNED`` (schnet in its place), ``ARCHS`` and ``cells()``."""
    assert T_CFG.ASSIGNED == R_CFG.ASSIGNED
    assert "schnet" in T_CFG.ASSIGNED
    assert list(T_CFG.ARCHS) == list(R_CFG.ARCHS)
    assert T_CFG.cells() == R_CFG.cells()
    assert [a for a in T_CFG.ASSIGNED
            if T_CFG.get(a).FAMILY == "lm"] == LM_ARCHS
    for arch in T_CFG.ASSIGNED:
        assert T_CFG.get(arch).FAMILY == R_CFG.get(arch).FAMILY


def test_get_raises_on_an_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch 'resnet'"):
        T_CFG.get("resnet")
    assert T_CFG.get("schnet").ARCH_ID == "schnet"
    assert T_CFG.get("schnet").FAMILY == "gnn"
    assert T_CFG.get("gemma2-9b").ARCH_ID == "gemma2-9b"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_config_counts_equal_the_reference(arch):
    ref, port = R_CFG.get(arch).config(), T_CFG.get(arch).config()
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.padded_vocab == ref.padded_vocab
    assert (port.n_blocks, port.block_layers) == (ref.n_blocks,
                                                  ref.block_layers)
    for got, want in zip(port.layer_locality(), ref.layer_locality()):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
    for j in range(port.block_layers):
        assert port.sub_uses_moe(j) == ref.sub_uses_moe(j)
        assert port.sub_d_ff(j) == ref.sub_d_ff(j)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("batch,max_len", [(1, 4096), (4, 4640),
                                           (128, 32768), (1, 524288)])
def test_cache_memory_bytes_equal_the_reference(arch, batch, max_len):
    ref, port = R_CFG.get(arch).config(), T_CFG.get(arch).config()
    for quantized in (True, False):
        assert (T_QC.cache_memory_bytes(port, batch, max_len, quantized)
                == R_QC.cache_memory_bytes(ref, batch, max_len, quantized))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_params_hold_param_count(arch):
    cfg = T_CFG.get(arch).config()
    aparams = T_TF.abstract_params(cfg)
    leaves = list(_leaves(aparams))
    assert all(t.device.type == "meta" for t in leaves)
    # the embedding's padded rows are parameters the count leaves out
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    assert sum(t.numel() for t in leaves) == cfg.param_count() + pad
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        R_TF.abstract_params(R_CFG.get(arch).config()))
    assert _shapes(aparams) == want


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_gemma2_9b_is_the_full_width_model():
    cfg = T_CFG.get("gemma2-9b").config()
    assert cfg.param_count() == 9_241_404_928
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_ff,
            cfg.vocab) == (3584, 16, 8, 256, 14336, 256000)
    assert (cfg.window, cfg.attn_softcap, cfg.final_softcap) == (4096, 50.0,
                                                                 30.0)
    assert cfg.tdtype == torch.bfloat16


# --------------------------------------------------------------------------
# sharding rules on the real LM parameter tree


class _StandIn:
    """A mesh of the given axis sizes: the rules read only its ``shape``
    and ``axis_names``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_sharding_on_real_parameters_equals_the_reference(arch):
    """Every leaf of the port's tree gets a spec of its rank, each sharded
    dim divides its axes on a 4-way mesh, and the specs equal the
    reference's rule on its own abstract tree."""
    cfg = T_CFG.get(arch).reduced_config()
    aparams = T_TF.abstract_params(cfg)
    ref_tree = R_TF.abstract_params(R_CFG.get(arch).reduced_config())
    leaves = _flat(aparams)
    for shape in ({"data": 1, "model": 4}, {"data": 4, "model": 1},
                  {"data": 2, "model": 2}, {"pod": 2, "data": 2,
                                            "model": 1}):
        mesh = _StandIn(shape)
        specs = {k: v.spec for k, v in _flat(
            TSH.lm_params_sharding(mesh, aparams)).items()}
        assert set(specs) == set(leaves)
        for path, spec in specs.items():
            shp = tuple(leaves[path].shape)
            assert len(spec) in (0, len(shp)), path
            for dim, axes in enumerate(spec):
                if axes is not None:
                    assert shp[dim] % TSH._axes_size(mesh, axes) == 0, path
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree):
            p = RSH._path_str(path)
            shp = tuple(int(v) for v in leaf.shape)
            want[p] = tuple(RSH.P(*(
                e if e is not None and RSH._divisible(shp, d, mesh, e)
                else None for d, e in enumerate(RSH._lm_rule(p, shp)))))
        assert {k: tuple(v) for k, v in specs.items()} == want, shape
    # on the 4-way model axis the embedding is vocab-sharded
    mesh = TSH.make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    specs = _flat(TSH.lm_params_sharding(mesh, aparams))
    assert tuple(specs["embed/table"].spec) == ("model", None)
    assert tuple(specs["layers/sub0/attn/wq/w"].spec) == (None, None, "model")
    assert tuple(specs["layers/sub0/attn/wo/w"].spec) == (None, "model", None)


@pytest.mark.parametrize("batch", [1, 4, 6])
def test_lm_cache_spec_on_the_port_cache(batch):
    cfg = T_CFG.get("gemma2-9b").reduced_config()
    mesh = TSH.make_mesh((4, 1), ("data", "model"), ["cpu"] * 4)
    spec = TSH.lm_cache_spec(mesh, batch)
    kc, _ = T_TF.make_cache(cfg, batch, 8, device="meta")
    if batch % 4 == 0:
        got = tuple(spec.spec)
        assert len(got) == kc.dim() and got[2] in ("data", ("data",))
        assert got[:2] + got[3:] == (None,) * 5
    else:
        assert tuple(spec.spec) == ()


# --------------------------------------------------------------------------
# lm_data


def test_lm_batch_shapes_dtypes_and_shift():
    g = torch.Generator().manual_seed(0)
    b = lm_data.lm_batch(g, 3, 10, 50, device="cpu")
    assert b["tokens"].shape == b["targets"].shape == (3, 10)
    assert b["tokens"].dtype == b["targets"].dtype == torch.int32
    assert b["mask"].dtype == torch.float32 and bool((b["mask"] == 1).all())
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert int(b["tokens"].min()) >= 0 and int(b["targets"].max()) < 50


def test_lm_batch_is_a_function_of_its_generator():
    a = lm_data.lm_batch(torch.Generator().manual_seed(3), 2, 8, 100,
                         device="cpu")
    b = lm_data.lm_batch(torch.Generator().manual_seed(3), 2, 8, 100,
                         device="cpu")
    c = lm_data.lm_batch(torch.Generator().manual_seed(4), 2, 8, 100,
                         device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])


@pytest.mark.parametrize("start", [1, 3])
def test_a_resumed_stream_equals_a_continuous_one(start):
    cont = lm_data.batch_iterator(2, 6, 1000, seed=5, device="cpu")
    whole = [next(cont) for _ in range(5)]
    resumed = lm_data.batch_iterator(2, 6, 1000, seed=5, start_step=start,
                                     device="cpu")
    for step in range(start, 5):
        got = next(resumed)
        for k in ("tokens", "targets", "mask"):
            assert torch.equal(got[k], whole[step][k]), (step, k)
    # no two steps repeat, and another seed is another stream
    assert len({tuple(b["tokens"].flatten().tolist()) for b in whole}) == 5
    other = next(lm_data.batch_iterator(2, 6, 1000, seed=6, device="cpu"))
    assert not torch.equal(other["tokens"], whole[0]["tokens"])


def test_lm_data_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(lm_data.batch_iterator(1, 4, 10))
