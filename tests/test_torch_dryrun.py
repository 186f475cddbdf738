"""The port's dry run (``launch.dryrun``, ``launch.cost_analysis``,
``launch.mesh.make_production_mesh``) against the JAX package's
(``launch/dryrun.py``, ``launch/hlo_analysis.py``), on the CPU.

  * ``roofline_terms`` equals JAX's on ``tests/test_distributed.py``'s two
    cases and a seeded grid; ``collective_stats`` of the four collectives
    of that file's HLO text, given as events, equals JAX's parse of it;
  * ``runnable_cells`` and every cell's ``input_specs`` equal JAX's;
    ``make_production_mesh``'s shapes and axes are JAX's;
  * ``abstract_params`` builds ``init_params``' tree (every leaf's path,
    shape and dtype) on ``meta`` for every smoke config;
  * FLOPs of a smoke forward (B = 2, S = 64) traced on ``meta`` against
    JAX's ``loop_aware_costs`` of the compiled forward: smollm-360m
    equal; granite-moe-1b-a400m and xlstm-350m apart by what their ops
    compute differently (module docstring of ``cost_analysis``, PERF.md):
    JAX's ``ragged_dot`` is counted as every (token, choice) row through
    every expert, k times the port's masked loop over the experts; the
    port's mLSTM chunk scan updates its state after the last chunk, which
    XLA drops as dead code in the cacheless forward;
  * per-device FLOPs at (1, 2) and (2, 1) follow the stated rule from the
    (1, 1) trace (the data axes divide the batch-leading work; at model 2
    every cell runs the mesh route, every dense weight and the attention
    split over 'model', and halves); a column-parallel call's shards and
    all-gather; a train step's gradient reduction at (2, 1) and, event
    for event from the cell's own placements, at (2, 2, 1);
  * the CPU and ``meta`` counts agree op for op (``FlopCounterMode``),
    the trace's peak and argument bytes on a known function;
  * step 0's repairs keep the CPU numbers: ``abfp_ref``'s forward and
    ``moe_block_sharded`` bit-equal to their outputs before the meta
    repairs (digests taken on that tree);
  * JAX's five mini CLI cells (``tests/test_dryrun_mini.py``) run on the
    port as subprocesses, all at once from the module's start: each
    writes an artifact with the fields the roofline reads and the
    per-device rule they follow, with neither ``jax`` nor ``repro``
    imported.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import smoke_config as jsmoke_config
from repro.launch import dryrun as jdryrun
from repro.launch.hlo_analysis import collective_stats as jcollective_stats
from repro.launch.hlo_analysis import loop_aware_costs
from repro.launch.hlo_analysis import roofline_terms as jroofline_terms
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro_torch.configs import ALL_ARCHS, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig, abfp_matmul
from repro_torch.core.tree import flatten_with_names
from repro_torch.kernels import ops
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models.layers import Numerics
from repro_torch.models.lm import abstract_params, forward, init_params

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ROOT = Path(__file__).resolve().parents[1]

# JAX's five mini cells (tests/test_dryrun_mini.py:28-52).
MINI_CELLS = [
    ("whisper-base", "prefill_32k", "4,2", "float"),
    ("whisper-base", "train_4k", "4,2", "float"),
    ("xlstm-350m", "long_500k", "4,2", "float"),
    ("smollm-360m", "decode_32k", "2,2,2", "float"),
    ("smollm-360m", "prefill_32k", "4,2", "abfp"),
]

# The fields test_dryrun_mini.py:71 asks of an artifact, and JAX's others
# (fits_80g for fits_16g).
ARTIFACT_FIELDS = (
    "arch", "shape", "mesh", "quant", "kind", "chips", "flops_per_device",
    "hbm_bytes_per_device", "hbm_bytes_pessimistic", "flops_naive",
    "hbm_bytes_naive", "collectives", "memory", "live_bytes_per_device",
    "fits_80g", "compile_seconds")

# Runs the port's CLI in-process and reports whether jax or repro got in.
_MINI = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
sys.argv = ["dryrun"] + sys.argv[2:]
rc = 0
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    rc = e.code or 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"rc": rc, "bad": bad}))
"""


@pytest.fixture(scope="module", autouse=True)
def mini_runs():
    """The five mini cells, started together when the module starts (each
    in its own interpreter, artifacts in a temporary directory); ended by
    the module's end."""
    tmp = tempfile.TemporaryDirectory()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPRO_TORCH_DRYRUN_ART_DIR"] = tmp.name
    procs = {}
    for arch, shape, mesh, quant in MINI_CELLS:
        procs[(arch, shape, mesh, quant)] = subprocess.Popen(
            [sys.executable, "-c", _MINI, str(ROOT / "src"), "--arch", arch,
             "--shape", shape, "--mesh-shape", mesh, "--quant", quant],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
    yield procs, tmp.name
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()
    tmp.cleanup()


# ---------------------------------------------------------------------------
# roofline_terms and collective_stats
# ---------------------------------------------------------------------------


def test_roofline_terms_equal_jax_on_its_cases_and_a_grid():
    cases = [(1e12, 1e9, 1e6, 256, 197e12, 819e9, 50e9),
             (1e9, 1e9, 1e9, 256, 197e12, 819e9, 50e9)]
    rng = np.random.default_rng(0)
    for _ in range(64):
        f, b, c = (float(v) for v in 10.0 ** rng.uniform(3, 16, 3))
        cases.append((f, b, c, int(rng.integers(1, 513)),
                      mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW,
                      mesh_lib.ICI_BW))
    for f, b, c, chips, pf, hb, ib in cases:
        kw = dict(peak_flops=pf, hbm_bw=hb, ici_bw=ib)
        assert cost_analysis.roofline_terms(f, b, c, chips, **kw) == \
            jroofline_terms(f, b, c, chips, **kw)
    t = cost_analysis.roofline_terms(1e12, 1e9, 1e6, chips=256,
                                     peak_flops=197e12, hbm_bw=819e9,
                                     ici_bw=50e9)
    assert t["bottleneck"] == "compute_s"


# tests/test_distributed.py's _HLO, verbatim.
_HLO = textwrap.dedent("""
ENTRY %main.1 (p: f32[256,1024]) -> f32[256,1024] {
  %param.1 = f32[256,1024]{1,0} parameter(0)
  %all-reduce.1 = f32[256,1024]{1,0} all-reduce(%param.1), replica_groups={{0,1,2,3}}, to_apply=%add
  %all-gather.2 = bf16[512,1024]{1,0} all-gather(%x), replica_groups=[4,2]<=[8], dimensions={0}
  %reduce-scatter.3 = f32[64,1024]{1,0} reduce-scatter(%y), replica_groups={{0,1}}, dimensions={0}
  %collective-permute.4 = f32[8,8]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  ROOT %add.5 = f32[256,1024]{1,0} add(%param.1, %param.1)
}
""")


def test_collective_stats_equal_jax_on_its_hlo():
    events = [("all-reduce", 256 * 1024 * 4, 4),
              ("all-gather", 512 * 1024 * 2, 2),
              ("reduce-scatter", 64 * 1024 * 4, 2),
              ("collective-permute", 8 * 8 * 4, 2)]
    assert cost_analysis.collective_stats(events) == jcollective_stats(_HLO)
    assert cost_analysis.collective_stats([]) == {
        "total": {"count": 0, "bytes": 0}}


# ---------------------------------------------------------------------------
# Cells, input specs, the production mesh, abstract params
# ---------------------------------------------------------------------------


def test_runnable_cells_and_input_specs_equal_jax():
    cells = dryrun.runnable_cells()
    assert cells == jdryrun.runnable_cells()
    assert len(cells) == 32
    dt = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    for arch, shape in cells:
        want = jdryrun.input_specs(arch, shape)
        got = dryrun.input_specs(arch, shape)
        assert list(got) == list(want), (arch, shape)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (arch, shape, k)
            assert got[k].dtype == dt[v.dtype.type], (arch, shape, k)
            assert got[k].device.type == "meta"
    assert set(dryrun.SHAPES) == set(JSHAPES)
    for name, sc in JSHAPES.items():
        got = dryrun.SHAPES[name]
        assert (got.seq_len, got.global_batch, got.kind) == (
            sc.seq_len, sc.global_batch, sc.kind)


def test_quant_configs_equal_jax():
    for quant in ("float", "abfp"):
        want = jdryrun._quant_cfg(quant)
        got = dryrun._quant_cfg(quant)
        for f in ("mode", "tile_width", "gain", "bits_w", "bits_x",
                  "bits_y", "noise_lsb"):
            assert getattr(got, f) == getattr(want, f), (quant, f)


def test_production_mesh_shapes_and_axes():
    m = mesh_lib.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert m.axis_names == ("data", "model")
    mp = mesh_lib.make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert mp.axis_names == ("pod", "data", "model")
    assert m.device_set() == {torch.device("meta")} == mp.device_set()
    assert mesh_lib.make_production_mesh(device="cpu").device_set() == {
        torch.device("cpu")}
    assert (mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW, mesh_lib.HBM_PER_CHIP,
            mesh_lib.ICI_BW) == (989e12, 3.35e12, 80e9, 450e9)
    mini = dryrun.make_mesh((2, 2, 2))
    assert mini.shape == {"pod": 2, "data": 2, "model": 2}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_params_match_init_params(arch):
    mcfg = smoke_config(arch)
    a_names, a_leaves = flatten_with_names(abstract_params(mcfg))
    c_names, c_leaves = flatten_with_names(init_params(0, mcfg, "cpu"))
    assert a_names == c_names
    for n, a, c in zip(a_names, a_leaves, c_leaves):
        assert a.device.type == "meta", n
        assert (tuple(a.shape), a.dtype) == (tuple(c.shape), c.dtype), n


# ---------------------------------------------------------------------------
# FLOPs against JAX's loop-aware HLO count
# ---------------------------------------------------------------------------


def _jax_forward_flops(mcfg_j, b, s):
    p = jax.eval_shape(lambda k: jinit_params(k, mcfg_j),
                       jax.random.PRNGKey(0))
    t = jax.ShapeDtypeStruct((b, s), jnp.int32)
    text = jax.jit(lambda p, t: jforward(p, t, mcfg_j)[0]).lower(
        p, t).compile().as_text()
    return loop_aware_costs(text)["flops"]


def _port_forward_flops(mcfg, b, s):
    p = abstract_params(mcfg)
    t = torch.empty((b, s), dtype=torch.int32, device="meta")
    with torch.no_grad():
        r = cost_analysis.traced_costs(lambda p, t: forward(p, t, mcfg)[0],
                                       p, t)
    return r["flops"]


def test_forward_flops_against_jax():
    b, s = 2, 64
    got = {a: _port_forward_flops(smoke_config(a), b, s)
           for a in ("smollm-360m", "granite-moe-1b-a400m", "xlstm-350m")}
    want = {a: _jax_forward_flops(jsmoke_config(a), b, s) for a in got}
    # A dense decoder: every dot the same.
    assert got["smollm-360m"] == want["smollm-360m"] == 100_663_296
    # MoE: the port's float route runs all T tokens through all E experts
    # (3 matmuls each); JAX's ragged_dot is counted as all T * k sorted
    # rows through every expert: k times the expert FLOPs.
    m = smoke_config("granite-moe-1b-a400m")
    t = b * s
    expert = m.num_layers * 3 * m.num_experts * 2 * t * m.d_model * m.d_ff
    assert want["granite-moe-1b-a400m"] - got["granite-moe-1b-a400m"] == \
        (m.experts_per_token - 1) * expert
    assert round(got["granite-moe-1b-a400m"]
                 / want["granite-moe-1b-a400m"], 3) == 0.530
    # xLSTM: the port's chunk scan also updates the mLSTM state after the
    # last chunk (a (dh x dh) product per head over the chunk), dead code
    # XLA drops in the cacheless forward.
    x = smoke_config("xlstm-350m")
    dh = 2 * x.d_model // x.num_heads
    n_mlstm = sum(x.layer_kind(i) == "mlstm" for i in range(x.num_layers))
    assert got["xlstm-350m"] - want["xlstm-350m"] == \
        n_mlstm * 2 * b * x.num_heads * s * dh * dh
    assert round(got["xlstm-350m"] / want["xlstm-350m"], 3) == 1.030


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-base",
                                  "xlstm-350m"])
def test_meta_trace_flops_equal_flop_counter_on_cpu(arch):
    """The trace's count equals FlopCounterMode's over the same cell run on
    CPU tensors, for each kind (the check phase 22 makes on the card)."""
    mcfg = smoke_config(arch)
    for sc in (ShapeConfig("t", 32, 4, "train"),
               ShapeConfig("p", 32, 2, "prefill"),
               ShapeConfig("d", 32, 2, "decode")):
        for quant in ("float", "abfp"):
            kw = dict(mcfg=mcfg, microbatches=2)
            costs = dryrun.trace_cell(dryrun.build_cell(
                arch, sc, dryrun.make_mesh((1, 1)), quant, **kw))
            cell = dryrun.build_cell(arch, sc, dryrun.make_mesh((1, 1)),
                                     quant, device="cpu", **kw)
            with FlopCounterMode(display=False) as fc:
                cell.fn(*cell.args)
            assert costs["flops_global"] == fc.get_total_flops() > 0, (
                sc.kind, quant)


# ---------------------------------------------------------------------------
# The per-device rule
# ---------------------------------------------------------------------------


def test_per_device_flops_follow_the_rule():
    """At (2, 1) the batch-leading work halves and the rest stays; at
    (1, 2) a dense model's prefill, decode and train work halves (the mesh
    route splits every dense weight and the attention heads over 'model',
    as GSPMD does in JAX's dry run); a column-parallel call's shard work
    halves."""
    mcfg = smoke_config("smollm-360m")
    for sc in (ShapeConfig("t", 32, 4, "train"),
               ShapeConfig("p", 32, 4, "prefill"),
               ShapeConfig("d", 32, 4, "decode")):
        one = dryrun.trace_cell(dryrun.build_cell(
            "smollm-360m", sc, dryrun.make_mesh((1, 1)), mcfg=mcfg,
            microbatches=2))
        cls = one["by_class"]
        assert set(cls) <= {"batch", "replicated"}
        assert cls["batch"]["flops"] > 0
        for shape, want in (((2, 1), cls["batch"]["flops"] / 2
                             + cls.get("replicated", {}).get("flops", 0)),
                            ((1, 2), one["flops"] / 2)):
            got = dryrun.trace_cell(dryrun.build_cell(
                "smollm-360m", sc, dryrun.make_mesh(shape), mcfg=mcfg,
                microbatches=2))
            assert got["flops_global"] == one["flops_global"]
            assert got["flops"] == pytest.approx(want, rel=1e-12), (
                sc.kind, shape)
            if shape == (1, 2):
                assert set(got["by_class"]) == {"batch", "replicated",
                                                "sharded"}
                assert got["by_class"]["sharded"]["flops"] == \
                    one["flops_global"]
    x = torch.empty((4, 8, 64), device="meta")
    w = torch.empty((64, 256), device="meta")
    mesh = dryrun.make_mesh((1, 2))
    r = cost_analysis.traced_costs(
        lambda x, w: ops.dense_tp(x, w, QuantConfig(mode="float"),
                                  mesh=mesh), x, w, mesh=mesh)
    assert r["flops_global"] == 2 * 4 * 8 * 64 * 256
    assert r["flops"] == r["flops_global"] / 2
    assert r["events"] == [("all-gather", 4 * 8 * 256 * 4, 2)]
    assert r["collectives"]["all-gather"] == {"count": 1,
                                              "bytes": 4 * 8 * 256 * 4 // 2}


def test_train_step_records_its_data_parallel_reductions():
    """At (2, 1) every leaf's gradient is reduced over 'data' (ZeRO-1
    leaves as a reduce-scatter and an all-gather), plus the loss and aux
    means; at (1, 1) nothing is recorded."""
    mcfg = smoke_config("smollm-360m")
    sc = ShapeConfig("t", 16, 4, "train")
    one = dryrun.trace_cell(dryrun.build_cell(
        "smollm-360m", sc, dryrun.make_mesh((1, 1)), mcfg=mcfg,
        microbatches=2))
    assert one["events"] == []
    two = dryrun.trace_cell(dryrun.build_cell(
        "smollm-360m", sc, dryrun.make_mesh((2, 1)), mcfg=mcfg,
        microbatches=2))
    kinds = [e[0] for e in two["events"]]
    n_leaves = len(flatten_with_names(abstract_params(mcfg))[1])
    assert kinds.count("reduce-scatter") == kinds.count("all-gather")
    assert kinds.count("all-reduce") + kinds.count("reduce-scatter") == \
        n_leaves + 2
    assert all(g == 2 for _, _, g in two["events"])


def test_train_step_reduction_on_a_pod_mesh_follows_the_cell_placements():
    """At (2, 2, 1) the events are pinned leaf by leaf from the cell's own
    placements: a ZeRO-1 leaf's gradient is reduce-scattered over 'data'
    (2), its piece all-reduced over 'pod' (2) and the updated parameter
    all-gathered over 'data' (2); every other leaf is all-reduced over
    pod x data (4); then the loss and aux means over 4."""
    mcfg = smoke_config("smollm-360m")
    sc = ShapeConfig("t", 16, 8, "train")
    cell = dryrun.build_cell("smollm-360m", sc, dryrun.make_mesh((2, 2, 1)),
                             mcfg=mcfg, microbatches=2)
    pspec, z1 = cell.grad_specs
    params = cell.args[0].params
    want, n_zero1 = [], 0
    for (p, spec), (_, zspec) in zip(cost_analysis.paired(params, pspec),
                                     cost_analysis.paired(params, z1)):
        assert cost_analysis.spec_split(spec, cell.mesh) == 1
        grad = p.numel() * 4.0              # the f32 microbatch sum
        if "data" in tuple(zspec):
            n_zero1 += 1
            want += [("reduce-scatter", grad / 2, 2),
                     ("all-reduce", grad / 2, 2),
                     ("all-gather", float(p.numel() * p.element_size()), 2)]
        else:
            want.append(("all-reduce", grad, 4))
    want += [("all-reduce", 4.0, 4)] * 2
    assert n_zero1 > 0
    assert dryrun.trace_cell(cell)["events"] == want


def test_traced_memory_on_a_known_function():
    """Arguments, a temporary, an in-place (donated) output and a fresh
    one: bytes, peak and live as the docstring states."""
    a = torch.empty((1024,), device="meta")             # 4 KiB
    b = torch.empty((256,), device="meta")              # 1 KiB

    def fn(a, b):
        t = a * 2.0                                     # 4 KiB temporary
        u = t + 1.0                                     # 4 KiB, t alive
        del t
        b.add_(1.0)                                     # donated in place
        return b, u.sum()                               # 4 bytes out

    r = cost_analysis.traced_costs(fn, a, b)
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] == 5120
    assert mem["alias_size_in_bytes"] == 1024
    assert mem["output_size_in_bytes"] == 1024 + 4
    assert r["live_bytes"] == 5120 + 8192               # args + peak
    assert r["flops"] == 0
    # a*2 and t+1 read 4 KiB and write 4 KiB; add_ 1 KiB twice; sum 4 KiB
    # in, 4 bytes out.
    assert r["hbm_bytes"] == 8192 * 2 + 2048 + 4096 + 4


# ---------------------------------------------------------------------------
# Step 0's repairs keep the CPU numbers
# ---------------------------------------------------------------------------


def _digest(*ts) -> str:
    m = hashlib.sha256()
    for t in ts:
        m.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return m.hexdigest()[:16]


# Taken on the tree before the repairs (the same code on the CPU).
_BEFORE = {
    "fwd_smollm-360m": "6bfe471683c939a1",
    "fwd_granite-moe-1b-a400m": "91cd5d62f94177fd",
    "abfp_matmul_hostkey": "0d8871f779f48d52",
    "moe_1.25_2x4": "fd3a91525b6026d8", "moe_1.25_1x4": "93383e03d33a9039",
    "moe_0.5_2x4": "f2b53e460dd06bb4", "moe_0.5_1x4": "0dd5a08271e29b42",
}
_QREF = QuantConfig(mode="abfp_ref", tile_width=32, gain=8.0, noise_lsb=0.5)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_abfp_ref_forward_bit_equal_to_before(arch):
    mcfg = smoke_config(arch)
    p = init_params(0, mcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, (2, 16)))
    with torch.no_grad():
        lg, aux = forward(p, toks, mcfg, Numerics(_QREF, prng.PRNGKey(3)))
    assert _digest(lg, aux) == _BEFORE[f"fwd_{arch}"]


def test_abfp_ref_host_key_draw_bit_equal_to_before():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(5, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(96, 40)).astype(np.float32))
    assert _digest(abfp_matmul(x, w, _QREF, prng.PRNGKey(7))) == \
        _BEFORE["abfp_matmul_hostkey"]


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 4)])
def test_moe_block_sharded_bit_equal_to_before(cf, mesh_shape):
    mcfg0 = smoke_config("granite-moe-1b-a400m")
    mp = moe.init_moe(torch.Generator().manual_seed(0), mcfg0, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 16, mcfg0.d_model)).astype(np.float32))
    mcfg = dataclasses.replace(mcfg0, capacity_factor=cf)
    y, a = moe.moe_block_sharded(mp, x, mcfg,
                                 Numerics(QuantConfig(mode="float")),
                                 make_host_mesh(*mesh_shape, "cpu"))
    assert _digest(y, a) == _BEFORE[f"moe_{cf}_{mesh_shape[0]}x"
                                    f"{mesh_shape[1]}"]


def test_moe_block_sharded_on_meta_pads_to_capacity():
    """On meta every group is padded to the shard's capacity: the expert
    FLOPs are an upper bound of the CPU run's; the partial sums and aux
    mean are recorded as all-reduces."""
    mcfg = smoke_config("granite-moe-1b-a400m")
    mp = moe.init_moe(torch.Generator().manual_seed(0), mcfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 16, mcfg.d_model)).astype(np.float32))
    nx = Numerics(QuantConfig(mode="float"))
    with FlopCounterMode(display=False) as fc:
        moe.moe_block_sharded(mp, x, mcfg, nx, make_host_mesh(2, 4, "cpu"))
    meta = {k: v.to("meta") for k, v in mp.items()}
    mesh = dryrun.make_mesh((2, 4))
    r = cost_analysis.traced_costs(
        lambda p, v: moe.moe_block_sharded(p, v, mcfg, nx, mesh), meta,
        x.to("meta"), mesh=mesh)
    assert r["flops_global"] >= fc.get_total_flops()
    assert [e[0] for e in r["events"]] == ["all-reduce", "all-reduce"]
    assert r["events"][0][2] == 4 and r["events"][1][2] == 8


# ---------------------------------------------------------------------------
# JAX's mini CLI cells on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", MINI_CELLS, ids=lambda c: "-".join(c))
def test_mini_cli_cell_writes_the_artifact(cell, mini_runs):
    procs, art = mini_runs
    arch, shape, mesh, quant = cell
    out, err = procs[cell].communicate(timeout=600)
    assert procs[cell].returncode == 0, out + err
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc == {"rc": 0, "bad": []}, out + err
    assert "cells traced OK" in out
    name = mesh.replace(",", "x")
    with open(os.path.join(art, f"{arch}__{shape}__{name}__{quant}.json")) \
            as fh:
        d = json.load(fh)
    for k in ARTIFACT_FIELDS:
        assert k in d, k
    assert (d["arch"], d["shape"], d["mesh"], d["quant"]) == (
        arch, shape, name, quant)
    assert d["chips"] == int(np.prod([int(v) for v in mesh.split(",")]))
    assert d["flops_per_device"] > 0 and d["live_bytes_per_device"] > 0
    assert d["flops_naive"] == d["hbm_bytes_naive"] == -1.0
    assert d["hbm_bytes_pessimistic"] == d["hbm_bytes_per_device"]
    assert "total" in d["collectives"]
    assert d["fits_80g"] == (d["live_bytes_per_device"]
                             <= mesh_lib.HBM_PER_CHIP)
    # The per-device rule is named beside the figures, with the whole
    # mesh's FLOPs split by class: every cell runs the mesh route.
    assert d["per_device_rule"] == "batch+model+moe"
    assert sum(v["flops"] for v in d["by_class"].values()) == \
        d["flops_global"]
