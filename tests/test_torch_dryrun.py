"""The dry run over the meta device (``repro_torch.launch.dryrun``)
against the reference's ``repro.launch.dryrun`` and against itself on the
CPU.

The reference compiles its cells with XLA; the port runs each step once
on the meta device.  What the two share is held equal here: the HLO
collective parser (on ``tests/test_dryrun_small.py``'s string and on drawn
HLO lines), the cell inventory, the record's keys.  The port's own
numbers are held to a CPU run: the meta FLOP count of a step equals
``torch.utils.flop_counter.FlopCounterMode``'s count of the same step on
zero-filled CPU tensors of the same shapes, and the per-shard argument
bytes equal each leaf's bytes over its spec's shards.  Configurations are
the reduced ones at small shapes on a 2x2 meta mesh.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
jax.devices()                      # the backend's device count is fixed now
_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as R_D  # noqa: E402  (sets XLA_FLAGS)

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import cells as r_cells  # noqa: E402
from repro.configs import get as r_get  # noqa: E402
from repro_torch.configs import cells, get  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: the record keys the port writes; the reference's other keys
#: (``bytes_accessed``, ``collectives``, ``temp_size_in_bytes``,
#: ``generated_code_size_in_bytes``) need XLA and stay absent
RECORD_KEYS = {"arch", "shape", "variant", "mesh", "n_devices",
               "compile_seconds", "flops", "memory_analysis"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes"}

#: the cells at small sizes (``small`` puts them in the configs)
LM_SMALL = {"train_4k": dict(kind="train", seq_len=64, global_batch=8),
            "prefill_32k": dict(kind="prefill", seq_len=64, global_batch=2),
            "decode_32k": dict(kind="decode", seq_len=64, global_batch=4)}
GNN_SMALL = {
    "full_graph_sm": dict(kind="full_graph", n_nodes=40, n_edges=150,
                          d_feat=24, n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n_nodes=500, n_edges=4000,
                         batch_nodes=4, fanout=(3, 2), d_feat=24,
                         n_classes=7, pad_nodes=4 * 10, pad_edges=4 * 9),
    "molecule": dict(kind="molecule", n_nodes=6, n_edges=12, batch=4)}
RECSYS_SMALL = {"train_batch": dict(kind="train", batch=32),
                "serve_p99": dict(kind="serve", batch=16),
                "retrieval_cand": dict(kind="retrieval", batch=3,
                                       n_candidates=1000)}
ANN_SMALL = {"product60m": dict(n=4000, d=32), "sift1m": dict(n=2000, d=16),
             "glove100": dict(n=1001, d=12)}


@pytest.fixture
def small(monkeypatch):
    """Every family's reduced config at small shapes (the LM ones with
    16-row q and kv tiles, so the tile skip has tiles to skip)."""
    for arch in ("gemma-2b", "gemma2-9b", "minicpm-2b",
                 "llama4-scout-17b-16e", "llama4-maverick-400b-17b"):
        mod = get(arch)
        cfg = dataclasses.replace(mod.reduced_config(), block_q=16,
                                  block_kv=16)
        monkeypatch.setattr(mod, "config", lambda cfg=cfg: cfg)
        monkeypatch.setattr(mod, "SHAPES", LM_SMALL)
    for arch in ("autoint", "dlrm-mlperf", "dien", "dcn-v2"):
        mod = get(arch)
        monkeypatch.setattr(mod, "config", mod.reduced_config)
        monkeypatch.setattr(mod, "SHAPES", RECSYS_SMALL)
    mod = get("schnet")
    monkeypatch.setattr(mod, "config", mod.reduced_config)
    monkeypatch.setattr(mod, "SHAPES", GNN_SMALL)
    monkeypatch.setattr(D, "_ANN", ANN_SMALL)


def _mesh():
    return SH.make_mesh((2, 2), ("data", "model"), devices=[D.META] * 4)


def _cpu(tree):
    """A nest of meta tensors as zero-filled CPU tensors (ints as they
    are): every index is 0, a valid one."""
    if torch.is_tensor(tree):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _cpu(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


# --------------------------------------------------------------------------
# the HLO collective parser


HLO = """
      %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x), replica_groups={}
      %ag.1 = (bf16[64]{0}, bf16[64]{0}) all-gather(bf16[32]{0} %y, bf16[32]{0} %z)
      %nothing = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)
    """


def test_collective_bytes_equals_the_reference_on_its_string():
    assert D.collective_bytes(HLO) == R_D.collective_bytes(HLO)
    out = D.collective_bytes(HLO)
    assert out["bytes"]["all-reduce"] == 128 * 256 * 4
    assert out["total_bytes"] == 128 * 256 * 4 + 256


_shape = st.builds(
    lambda dt, dims: f"{dt}[{','.join(map(str, dims))}]{{0}}",
    st.sampled_from([*R_D._DTYPE_BYTES, "c64", "token"]),
    st.lists(st.integers(0, 4096), max_size=3))
_line = st.builds(
    lambda name, shapes, op, start, pad: (
        f"{pad}%{name} = ({', '.join(shapes)}) {op}{start}(f32[4]{{0}} %x)"
        if len(shapes) > 1 else
        f"{pad}%{name} = {shapes[0]} {op}{start}(f32[4]{{0}} %x)"),
    st.from_regex(r"[a-z][a-z0-9.]{0,6}", fullmatch=True),
    st.lists(_shape, min_size=1, max_size=3),
    st.sampled_from([*R_D._COLLECTIVES, "add", "fusion", "all-reduce-done"]),
    st.sampled_from(["", "-start"]), st.sampled_from(["", "  ", "ROOT "]))


@settings(max_examples=60, deadline=None)
@given(st.lists(_line, max_size=8))
def test_collective_bytes_equals_the_reference_on_drawn_lines(lines):
    text = "\n".join(lines)
    assert D.collective_bytes(text) == R_D.collective_bytes(text)


# --------------------------------------------------------------------------
# cells


def test_cells_equal_the_reference():
    cs = cells()
    assert cs == r_cells()
    assert len(cs) == 40 and sum(1 for c in cs if c[2]) == 2
    fam = [get(a).FAMILY for a, _s, _k in cs]
    assert (fam.count("lm"), fam.count("gnn"), fam.count("recsys")) == (
        20, 4, 16)
    assert get("lpq-ann").SHAPES == r_get("lpq-ann").SHAPES


def test_meta_mesh_shapes():
    pod, multi = D.meta_mesh(False), D.meta_mesh(True)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in multi.shard_devices()} == {"meta"}


@pytest.mark.parametrize("arch,shape,variant", [
    ("gemma2-9b", "train_4k", "baseline"),
    ("gemma-2b", "prefill_32k", "baseline"),
    ("llama4-scout-17b-16e", "decode_32k", "baseline"),
    ("minicpm-2b", "decode_32k", "int8kv"),
    ("dlrm-mlperf", "train_batch", "baseline"),
    ("dien", "serve_p99", "int8"),
    ("autoint", "retrieval_cand", "int8"),
    ("schnet", "minibatch_lg", "baseline"),
    ("schnet", "molecule", "baseline"),
    ("lpq-ann", "product60m", "baseline"),
    ("lpq-ann", "glove100", "fp32"),
])
def test_each_family_builds_on_a_small_meta_mesh(small, arch, shape,
                                                 variant):
    cell = D.build_cell(arch, shape, _mesh(), variant)
    flops, out = D.count_flops(cell.fn, cell.args)
    assert flops > 0
    assert D.tree_bytes(cell.args, cell.in_specs) > 0
    assert D.tree_bytes(out, cell.out_specs) > 0


# --------------------------------------------------------------------------
# meta FLOPs against FlopCounterMode on the CPU


@pytest.mark.parametrize("arch,shape,variant", [
    ("gemma2-9b", "prefill_32k", "baseline"),      # sliding window: skips
    ("gemma-2b", "train_4k", "baseline"),
    ("dcn-v2", "serve_p99", "baseline"),
    ("dlrm-mlperf", "retrieval_cand", "int8"),
    ("dlrm-mlperf", "retrieval_cand", "baseline"),
    ("schnet", "full_graph_sm", "baseline"),
])
def test_meta_flops_equal_flop_counter_mode_on_the_cpu(small, arch, shape,
                                                       variant):
    cell = D.build_cell(arch, shape, _mesh(), variant)
    flops, out = D.count_flops(cell.fn, cell.args)
    cpu = D.build_cell(arch, shape, _mesh(), variant)
    with FlopCounterMode(display=False) as counter:
        want = cpu.fn(*_cpu(cpu.args))
    assert flops == counter.get_total_flops() > 0
    assert D.tree_bytes(out, cell.out_specs) == D.tree_bytes(
        want, cpu.out_specs)


def test_the_tile_skip_counts_the_live_tiles_only(small, monkeypatch):
    """gemma2-9b's reduced config alternates a window of 8 with global
    layers: at 64 positions in 16-row tiles its prefill counts fewer
    FLOPs than the same model with no window."""
    mod = get("gemma2-9b")
    cell = D.build_cell("gemma2-9b", "prefill_32k", _mesh())
    windowed, _ = D.count_flops(cell.fn, cell.args)
    wide = dataclasses.replace(mod.config(), window=2 ** 30)
    monkeypatch.setattr(mod, "config", lambda: wide)
    cell = D.build_cell("gemma2-9b", "prefill_32k", _mesh())
    full, _ = D.count_flops(cell.fn, cell.args)
    assert 0 < windowed < full


# --------------------------------------------------------------------------
# per-shard bytes


def _leaves(tree, spec):
    if torch.is_tensor(tree):
        yield tree, spec
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, spec if isinstance(spec, SH.Named)
                               else spec[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, spec if isinstance(spec, SH.Named)
                               else spec[i])


@pytest.mark.parametrize("arch,shape", [("gemma-2b", "train_4k"),
                                        ("dlrm-mlperf", "train_batch"),
                                        ("schnet", "full_graph_sm")])
def test_argument_bytes_are_each_leafs_bytes_over_its_shards(small, arch,
                                                             shape):
    mesh = _mesh()
    cell = D.build_cell(arch, shape, mesh)
    want = 0
    sharded = 0
    for leaf, named in _leaves(cell.args, cell.in_specs):
        shards = 1
        for entry in named.spec:
            for axis in ((entry,) if isinstance(entry, str)
                         else entry or ()):
                shards *= mesh.shape[axis]
        assert (leaf.numel() * leaf.element_size()) % shards == 0
        want += leaf.numel() * leaf.element_size() // shards
        sharded += shards > 1
    assert sharded > 0
    assert D.tree_bytes(cell.args, cell.in_specs) == want
    # a train step donates its parameters and optimizer state
    rec_alias = sum(D.tree_bytes(cell.args[i], cell.in_specs[i])
                    for i in D.DONATE["train"])
    assert 0 < rec_alias < want


def test_shard_bytes_rounds_each_dimension_up():
    mesh = _mesh()
    x = torch.empty((5, 3), device="meta")
    assert D.shard_bytes(x, SH.named(mesh, SH.P("data", None))) == 3 * 3 * 4
    assert D.shard_bytes(x, SH.named(mesh, SH.P(("data", "model")))) == (
        2 * 3 * 4)
    assert D.shard_bytes(x, None) == D.shard_bytes(
        x, SH.named(mesh, SH.P())) == 15 * 4
    assert D.shard_bytes(7, None) == 4


# --------------------------------------------------------------------------
# records and the command line


def test_main_writes_the_reference_record(tmp_path, capsys):
    rc = D.main(["--arch", "schnet", "--shape", "molecule", "--multi-pod",
                 "no", "--out", str(tmp_path)])
    assert rc == 0
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["schnet__molecule__pod.json"]
    rec = json.loads(files[0].read_text())
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert rec["arch"] == "schnet" and rec["shape"] == "molecule"
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["variant"] == "baseline" and rec["flops"] > 0
    mem = rec["memory_analysis"]
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    assert "[dryrun] done: 1 ok, 0 skipped, 0 failed" in capsys.readouterr().out


def test_main_records_skips_and_failures(tmp_path, capsys, monkeypatch):
    rc = D.main(["--arch", "gemma-2b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    assert rc == 0
    for mesh, tag in (("16x16", "pod"), ("2x16x16", "multipod")):
        rec = json.loads(
            (tmp_path / f"gemma-2b__long_500k__{tag}.json").read_text())
        assert rec["mesh"] == mesh and "skipped" in rec
    assert "2 skipped, 0 failed" in capsys.readouterr().out

    def boom(*_a, **_k):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(D, "run_cell", boom)
    rc = D.main(["--arch", "schnet", "--shape", "molecule", "--multi-pod",
                 "yes", "--variant", "int8", "--out", str(tmp_path)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "[dryrun] FAIL schnet__molecule__multipod__int8" in out
    assert "0 ok, 0 skipped, 1 failed" in out


def test_the_sweep_imports_no_jax(tmp_path):
    """The command line in a process of its own: the SchNet cells and one
    ANN cell on both meshes, and no JAX module loaded after them."""
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun\n"
        f"rc = dryrun.main(['--arch', 'schnet', '--out', {str(tmp_path)!r}])\n"
        f"rc |= dryrun.main(['--arch', 'lpq-ann', '--shape', 'sift1m', "
        f"'--out', {str(tmp_path)!r}])\n"
        "assert not [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'repro.'))], 'jax loaded'\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "[dryrun] done: 8 ok, 0 skipped, 0 failed" in run.stdout
    assert "[dryrun] done: 2 ok, 0 skipped, 0 failed" in run.stdout
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 10
    assert all(r["flops"] > 0
               and r["memory_analysis"]["argument_size_in_bytes"] > 0
               for r in recs)


def test_the_default_out_is_not_the_references(tmp_path, monkeypatch):
    """The reference's ``test_dryrun_artifacts_exist_and_clean`` reads
    ``experiments/dryrun``; the port's records go elsewhere."""
    monkeypatch.chdir(tmp_path)
    assert D.main(["--arch", "schnet", "--shape", "molecule",
                   "--multi-pod", "no"]) == 0
    assert [p.name for p in (tmp_path / "experiments").iterdir()] == [
        "dryrun_torch"]
    assert (tmp_path / "experiments" / "dryrun_torch"
            / "schnet__molecule__pod.json").is_file()
