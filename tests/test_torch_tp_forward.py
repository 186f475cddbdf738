"""Dense tensor parallelism on a mesh: ``forward(mesh=)``,
``make_train_step(mesh=)`` and the dry run's prefill and train cells split
every dense weight over 'model' as GSPMD partitions the JAX package's
dry-run cells, on the CPU.

JAX's values come from one subprocess on eight forced placeholder CPU
devices under a ``jax.sharding.Mesh``, its steps jitted with
``in_shardings`` from ``param_spec_tree`` and ``batch_spec`` (as
``src/repro/launch/dryrun.py:130-204`` compiles its cells), on
tinyllama-1.1b's smoke config (init key 0, f32: 2 layers, 4 query / 2 KV
heads of 32, d_ff 256, vocab 512); the port gets the same weights through
``from_jax_params``.  The per-device FLOPs are JAX's dry run's own
(``launch.dryrun._run_cell``, its ``loop_aware_costs`` of the compiled
cell) on the smoke config at 4 x 64 tokens, 2 microbatches.

Bars:
  * the float forward's logits within 1e-4 (absolute) of JAX's
    GSPMD-compiled mesh forward at (1, 2) and (2, 2); two SGD steps'
    loss and grad_norm within 1e-5 relative of JAX's mesh steps (SGD:
    AdamW's first step can move an element by lr near eps, ROADMAP
    queue 3);
  * the ``abfp_ref`` forward (tile 32, gain 8, noise 0.5) bit-equal to
    the one-device port forward at (1, 2), (2, 2) and (1, 4): column
    shards draw their noise at their global counters, and the ABFP spec
    tree demotes every row split;
  * chatglm3-6b's smoke K/V (2 KV heads) at model 4 split inside a head:
    they are gathered (all-gathers recorded) and the forward stays within
    the float bar of the one-device forward;
  * per-device FLOPs: a prefill cell's equal JAX's at (1, 2) and (2, 2)
    within 1 %, its collectives' counts and bytes equal JAX's; a train
    cell's are the one-device gap times JAX's (the whole-mesh counts part
    by the remat policy: XLA drops the MLP ``wo`` recompute as dead code
    and merges the nested attention recompute, 1.068x at (1, 1), ROADMAP
    queue 3), and the model axis halves them exactly as it halves JAX's;
    query heads that do not split over 'model' (15 over 2) run attention
    whole, as GSPMD's reshape does, per-device FLOPs equal JAX's;
  * a train cell's backward is attributed per shard (no FLOPs outside a
    shard scope at (1, 2)).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.distributed.sharding import abfp_param_spec_tree as j_abfp_specs
from repro.distributed.sharding import param_spec_tree as j_param_specs
from repro.models import init_params as j_init_params
from repro_torch import optim
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.distributed.sharding import model_split, tp_route
from repro_torch.kernels import ops
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import forward
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import Numerics
from repro_torch.training import TrainConfig, make_train_step

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
MESHES = [(1, 2), (2, 2)]
BATCH = (4, 17)
STEPS = 2
QREF = QuantConfig(mode="abfp_ref", tile_width=32, gain=8.0, noise_lsb=0.5)
# smollm-360m's smoke config with smollm's own 15 / 5 heads: 15 query
# heads do not split over 2.
H15 = dict(num_heads=15, num_kv_heads=5)
FLOP_MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
RECURRENT = ["recurrentgemma-2b", "xlstm-350m"]
# Decode cells: heads split at (1, 2); chatglm3-6b's 2 KV heads over 4
# split the cache's head dim; recurrentgemma-2b's one KV head too.
DECODE = [(ARCH, (1, 2)), ("chatglm3-6b", (1, 4)),
          ("recurrentgemma-2b", (1, 2)), ("xlstm-350m", (1, 2))]
# (arch, kind, mesh) of every cell whose per-device FLOPs are compared.
FLOP_CELLS = ([(ARCH, k, sh) for k in "pt" for sh in FLOP_MESHES]
              + [("h15", "p", (1, 1)), ("h15", "p", (1, 2))]
              + [(a, "d", sh) for a, m in DECODE for sh in ((1, 1), m)]
              + [(a, "p", (1, 2)) for a in RECURRENT])

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import batch_spec, param_spec_tree
from repro.launch import dryrun as jd
from repro.models import forward, init_params
from repro.optim import optimizers as jopt
from repro.training.train_lib import TrainConfig, make_train_step

out_path = sys.argv[1]
b, s, steps = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
h15 = json.loads(sys.argv[5])
mcfg = smoke_config("tinyllama-1.1b")
params = init_params(jax.random.PRNGKey(0), mcfg)
toks = [np.random.default_rng(7 + i).integers(
    1, mcfg.vocab_size, (b, s)).astype(np.int32) for i in range(steps)]


def mesh(shape):
    names = ("data", "model")
    return jax.sharding.Mesh(np.array(jax.devices()[:int(np.prod(shape))])
                             .reshape(shape), names)


def ns(m, tree):
    return jax.tree.map(lambda sp: NamedSharding(m, sp), tree,
                        is_leaf=lambda x: isinstance(x, P))


res, mets = {}, {}
for shape in ((1, 2), (2, 2)):
    m, tag = mesh(shape), "%dx%d" % shape
    psh = ns(m, param_spec_tree(params, m))
    t0 = jnp.asarray(toks[0][:, :-1])
    tsh = NamedSharding(m, batch_spec(m, t0.shape))
    fwd = jax.jit(lambda p, t: forward(p, t, mcfg)[0],
                  in_shardings=(psh, tsh))
    res["logits_" + tag] = np.asarray(fwd(jax.device_put(params, psh),
                                          jax.device_put(t0, tsh)))
    init, step = make_train_step(mcfg, jopt.SGD(jopt.constant(1e-2)),
                                 TrainConfig())
    st = init(params)
    rep = NamedSharding(m, P())
    st_sh = type(st)(params=psh,
                     opt_state=jax.tree.map(lambda _: rep, st.opt_state),
                     ef=None, step=rep)
    bsh = {"tokens": NamedSharding(m, batch_spec(m, toks[0].shape))}
    step = jax.jit(step, in_shardings=(st_sh, bsh, rep),
                   out_shardings=(st_sh, None))
    st = jax.device_put(st, st_sh)
    mets[tag] = []
    for i in range(steps):
        key = jax.device_put(
            jax.random.fold_in(jax.random.PRNGKey(10 + i), 5), rep)
        st, met = step(st, jax.device_put({"tokens": toks[i]}, bsh), key)
        mets[tag].append({k: float(v) for k, v in met.items()})

# The dry run's own compile of smoke-size cells (4 x 64, 2 microbatches).
cfgs = {a: smoke_config(a) for a in json.loads(sys.argv[6])}
cfgs["h15"] = dataclasses.replace(smoke_config("smollm-360m"), **h15)
jd.get_config = cfgs.__getitem__
jd.SHAPES["p"] = ShapeConfig("p", 64, 4, "prefill")
jd.SHAPES["t"] = ShapeConfig("t", 64, 4, "train")
jd.SHAPES["d"] = ShapeConfig("d", 64, 4, "decode")
flops, colls = {}, {}
for arch, kind, shape in json.loads(sys.argv[7]):
    shape = tuple(shape)
    r = jd._run_cell(arch, kind, mesh(shape), "x", "float", save=False,
                     microbatches=2)
    tag = "%s_%s_%dx%d" % ((arch, kind) + shape)
    flops[tag] = r["flops_per_device"]
    colls[tag] = r["collectives"]
np.savez(out_path, **res)
print("RESULT " + json.dumps({"mets": mets, "flops": flops,
                              "colls": colls}))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_forward") / "jax.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                        *map(str, BATCH), str(STEPS), json.dumps(H15),
                        json.dumps(sorted({a for a, _, _ in FLOP_CELLS}
                                          - {"h15"})),
                        json.dumps(FLOP_CELLS)],
                       capture_output=True, text=True, timeout=900, env=env,
                       cwd=ROOT)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, r.stdout + r.stderr
    return dict(np.load(out)), json.loads(line[0][7:])


def _pair(arch, **repl):
    jm = dataclasses.replace(j_smoke_config(arch), **repl)
    tm = dataclasses.replace(smoke_config(arch), **repl)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return tm, jp, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                   device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _pair(ARCH)


def _tokens(i, vocab):
    return np.random.default_rng(7 + i).integers(
        1, vocab, BATCH).astype(np.int32)


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 4)], ids=_tag)
def test_routes_follow_jax_spec_trees(tiny, shape):
    """Every 2-D leaf's route is where JAX's validated spec puts 'model':
    its columns (COLUMN), its rows (ROW) or nowhere (WHOLE), by
    ``param_spec_tree`` and, demoted, ``abfp_param_spec_tree``."""
    tm, jp, _ = tiny
    devs = np.asarray(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    jmesh = jax.sharding.Mesh(devs, ("data", "model"))
    mesh = make_host_mesh(*shape, "cpu")
    for demote, jtree in ((False, j_param_specs), (True, j_abfp_specs)):
        jspecs = jtree(jp, jmesh)
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        n_split = 0
        for (path, leaf), spec in zip(flat, jax.tree.leaves(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
            names = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)
            stacked = "groups" in names
            if leaf.ndim - stacked != 2:
                continue
            parts = tuple(spec) + (None,) * (leaf.ndim - len(spec))
            parts = parts[stacked:]
            want = (ops.COLUMN if parts[1] == "model" else
                    ops.ROW if parts[0] == "model" else ops.WHOLE)
            got = tp_route(names, leaf.shape[-2:], mesh, demote)
            assert got == want, (names, spec)
            n_split += want != ops.WHOLE
        assert n_split > 0


# ---------------------------------------------------------------------------
# Values against JAX's GSPMD mesh runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_float_forward_on_a_mesh_matches_jax_gspmd(jax_run, tiny, shape):
    data, _ = jax_run
    tm, _, tp = tiny
    toks = torch.from_numpy(_tokens(0, tm.vocab_size)[:, :-1])
    logits, _ = forward(tp, toks, tm, mesh=make_host_mesh(*shape, "cpu"))
    want = data["logits_" + _tag(shape)]
    err = float(np.abs(logits.numpy() - want).max())
    print(f"{_tag(shape)}: max |logits - JAX's| = {err:.3g}")
    assert err <= 1e-4


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_float_sgd_steps_on_a_mesh_match_jax_gspmd(jax_run, tiny, shape):
    _, got = jax_run
    tm, _, tp = tiny
    init, step = make_train_step(tm, optim.SGD(optim.constant(1e-2)),
                                 TrainConfig(), device="cpu",
                                 mesh=make_host_mesh(*shape, "cpu"))
    st = init(tp)
    for i in range(STEPS):
        st, met = step(st, {"tokens": _tokens(i, tm.vocab_size)},
                       prng.fold_in(prng.PRNGKey(10 + i), 5))
        want = got["mets"][_tag(shape)][i]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), want[k], rtol=1e-5)


# ---------------------------------------------------------------------------
# The port's own one-device forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "chatglm3-6b"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=_tag)
def test_abfp_ref_forward_on_a_mesh_is_bit_equal(arch, shape):
    tm, _, tp = _pair(arch)
    toks = torch.from_numpy(_tokens(1, tm.vocab_size)[:, :-1])
    with torch.no_grad():
        one, _ = forward(tp, toks, tm, Numerics(QREF, prng.PRNGKey(3)))
        got, _ = forward(tp, toks, tm, Numerics(QREF, prng.PRNGKey(3)),
                         mesh=make_host_mesh(*shape, "cpu"))
    assert torch.equal(one, got)


def test_kv_split_inside_a_head_takes_the_gather_route():
    """chatglm3-6b's smoke K/V (2 KV heads x 32) over model 4 split inside
    a head: traced, each layer's wk and wv outputs are all-gathered and
    the query shards read their KV heads from the whole K/V; the float
    forward stays within the float bar of the one-device forward."""
    tm, _, tp = _pair("chatglm3-6b")
    assert tm.num_kv_heads % 4 and (tm.num_kv_heads
                                    * tm.resolved_head_dim) % 4 == 0
    mesh = make_host_mesh(1, 4, "cpu")
    toks = torch.from_numpy(_tokens(2, tm.vocab_size)[:, :-1])
    with torch.no_grad():
        one, _ = forward(tp, toks, tm)
        got, _ = forward(tp, toks, tm, mesh=mesh)
    assert float((one - got).abs().max()) <= 1e-4
    b, s = toks.shape
    kv_bytes = b * s * tm.num_kv_heads * tm.resolved_head_dim * 4
    meta_mesh = dryrun.make_mesh((1, 4))
    with torch.no_grad():
        r = cost_analysis.traced_costs(
            lambda p, t: forward(p, t, tm, mesh=meta_mesh)[0],
            _to_meta(tp), toks.to("meta"), mesh=meta_mesh)
    gathers = [e for e in r["events"] if e[0] == "all-gather"]
    assert gathers.count(("all-gather", float(kv_bytes), 4)) == \
        2 * tm.num_layers
    assert r["flops"] == r["flops_global"] / 4


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v) for v in tree]
    return tree.to("meta")


def test_column_route_is_bit_equal_and_its_backward_reduces_dx():
    """``dense_column`` in float and in ``abfp_ref`` (noise drawn) equals
    the whole call's columns bit for bit; under autograd its dw is the
    whole call's and its dx the shards' f32 sum, recorded as one
    all-reduce."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    key = prng.PRNGKey(9)
    for cfg, k in ((QuantConfig(mode="float"), None), (QREF, key)):
        whole = ops.dense(x, w, cfg, k)
        parts = ops.dense_column(x, w, cfg, k, 4)
        assert torch.equal(torch.cat(parts, -1), whole), cfg.mode
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(3, 5, 96)).astype(np.float32))
    (ops.dense(xg, wg, QREF, key) * g).sum().backward()
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    parts = ops.dense_column(xs, ws, QREF, key, 4)
    (torch.cat(parts, -1) * g).sum().backward()
    assert torch.equal(ws.grad, wg.grad)
    torch.testing.assert_close(xs.grad, xg.grad, rtol=1e-5, atol=1e-5)
    mesh = dryrun.make_mesh((1, 4))

    def step(x, w):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            ps = ops.dense_column(x, w, QuantConfig(mode="float"), None, 4)
            (dx,) = torch.autograd.grad(torch.cat(ps, -1).sum(), [x])
        return dx

    r = cost_analysis.traced_costs(step, x.to("meta"), w.to("meta"),
                                   mesh=mesh)
    assert r["events"] == [("all-reduce", float(3 * 5 * 64 * 4), 4)]
    assert r["flops"] == r["flops_global"] / 4


def test_row_route_sums_its_shards():
    """``dense_row`` over 4 input shards: the whole product within f32
    rounding, one all-reduce; its gradients are the whole call's."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(6, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 48)).astype(np.float32))
    cfg = QuantConfig(mode="float")
    xs = [p.clone().requires_grad_(True) for p in ops.split_columns(x, 4)]
    wr = w.clone().requires_grad_(True)
    y = ops.dense_row(xs, wr, cfg, 4)
    torch.testing.assert_close(y, x @ w, rtol=1e-5, atol=1e-4)
    y.sum().backward()
    torch.testing.assert_close(torch.cat([p.grad for p in xs], -1),
                               torch.ones(6, 48) @ w.t())
    torch.testing.assert_close(wr.grad, x.t() @ torch.ones(6, 48))
    with pytest.raises(ValueError):
        ops.dense_row(xs, w, QREF, 4)
    mesh = dryrun.make_mesh((1, 4))
    r = cost_analysis.traced_costs(
        lambda *a: ops.dense_row(list(a[1:]), a[0], cfg, 4), w.to("meta"),
        *(p.detach().to("meta") for p in xs), mesh=mesh)
    assert r["events"] == [("all-reduce", float(6 * 48 * 4), 4)]


def test_model_split_follows_the_numerics():
    """Float routes by ``param_spec_tree``, ``abfp_ref`` by the demoted
    tree (no row split), the kernel modes keep every dense call whole."""
    mesh = make_host_mesh(1, 2, "cpu")
    w_row = torch.empty(128, 64)
    assert model_split(make_host_mesh(2, 1, "cpu"),
                       QuantConfig(mode="float")) is None
    for mode, want in (("float", ops.ROW), ("abfp_ref", ops.WHOLE),
                       ("abfp_kernel", ops.WHOLE)):
        sp = model_split(mesh, QuantConfig(mode=mode))
        assert sp.dense_route(("attn", "wo"), w_row) == want, mode
    sp = model_split(mesh, QuantConfig(mode="abfp_ref"))
    assert sp.dense_route(("mlp", "wi"), torch.empty(64, 128)) == ops.COLUMN
    sp = model_split(mesh, QuantConfig(mode="abfp_kernel"))
    assert sp.dense_route(("mlp", "wi"), torch.empty(64, 128)) == ops.WHOLE


# ---------------------------------------------------------------------------
# The dry run's per-device figures against JAX's
# ---------------------------------------------------------------------------


_SHAPES = {"p": ShapeConfig("p", 64, 4, "prefill"),
           "t": ShapeConfig("t", 64, 4, "train"),
           "d": ShapeConfig("d", 64, 4, "decode")}


@pytest.fixture(scope="module")
def port_flops():
    cfgs = {a: smoke_config(a) for a, _, _ in FLOP_CELLS if a != "h15"}
    cfgs["h15"] = dataclasses.replace(smoke_config("smollm-360m"), **H15)
    out = {}
    for arch, kind, shape in FLOP_CELLS:
        cell = dryrun.build_cell(arch, _SHAPES[kind],
                                 dryrun.make_mesh(shape), mcfg=cfgs[arch],
                                 microbatches=2)
        out[f"{arch}_{kind}_{_tag(shape)}"] = dryrun.trace_cell(cell)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_prefill_cell_per_device_flops_equal_jax(jax_run, port_flops,
                                                 shape):
    _, got = jax_run
    tag = f"{ARCH}_p_{_tag(shape)}"
    r = port_flops[tag]
    assert r["flops"] == pytest.approx(got["flops"][tag], rel=0.01)
    assert r["collectives"] == got["colls"][tag]


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_train_cell_per_device_flops_against_jax(jax_run, port_flops,
                                                 shape):
    """The train cell: the port's whole-mesh count is JAX's times the
    one-device gap (the remat policy), and 'model' halves the per-device
    count exactly as it halves JAX's."""
    _, got = jax_run
    mine = {sh: port_flops[f"{ARCH}_t_{_tag(sh)}"]["flops"]
            for sh in FLOP_MESHES}
    jax_ = {sh: got["flops"][f"{ARCH}_t_{_tag(sh)}"] for sh in FLOP_MESHES}
    gap = mine[(1, 1)] / jax_[(1, 1)]
    print(f"train: port / JAX at (1, 1) {gap:.4f}")
    assert 1.0 <= gap < 1.08
    dp = shape[0]
    assert mine[shape] / mine[(dp, 1)] == pytest.approx(
        jax_[shape] / jax_[(dp, 1)], rel=1e-9)
    if dp == 1:
        assert mine[shape] == pytest.approx(jax_[shape] * gap, rel=0.01)


def test_train_cell_backward_is_attributed_per_shard(port_flops):
    r = port_flops[f"{ARCH}_t_1x2"]
    cls = r["by_class"]
    assert cls["sharded"]["flops"] == r["flops_global"] > 0
    assert cls["batch"]["flops"] == cls["replicated"]["flops"] == 0
    assert r["flops"] == r["flops_global"] / 2


def test_unsplit_query_heads_run_attention_whole(jax_run, port_flops):
    """15 query heads over model 2: q/k/v are gathered and attention runs
    whole on each device, the dense calls split: per-device FLOPs equal
    JAX's (its reshape of a 2-way split of 15 x 32 columns to heads
    gathers too)."""
    _, got = jax_run
    for shape in ((1, 1), (1, 2)):
        tag = f"h15_p_{_tag(shape)}"
        assert port_flops[tag]["flops"] == pytest.approx(got["flops"][tag],
                                                         rel=0.01)
    assert port_flops["h15_p_1x2"]["flops"] > \
        port_flops["h15_p_1x1"]["flops"] / 2


@pytest.mark.parametrize("arch,shape", DECODE,
                         ids=[f"{a}-{_tag(m)}" for a, m in DECODE])
def test_decode_cell_per_device_flops_equal_jax(jax_run, port_flops, arch,
                                                shape):
    """The decode step on a mesh: the dense calls, the cache attention
    (per head shard, or per head-dim shard where the KV heads do not
    split) and the recurrent states split as GSPMD splits JAX's decode
    cell: per-device FLOPs equal at (1, 1) and on the mesh."""
    _, got = jax_run
    for sh in ((1, 1), shape):
        tag = f"{arch}_d_{_tag(sh)}"
        assert port_flops[tag]["flops"] == pytest.approx(got["flops"][tag],
                                                         rel=0.01), tag
    assert port_flops[f"{arch}_d_{_tag(shape)}"]["flops"] == pytest.approx(
        port_flops[f"{arch}_d_1x1"]["flops"] / shape[1], rel=1e-9)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_cell_per_device_flops_equal_jax(
        jax_run, port_flops, arch):
    """RG-LRU's channels and the xLSTM heads split: per-device FLOPs at
    (1, 2) within 1 % of JAX's (the mesh route also drops the mLSTM state
    update after the last chunk, which XLA drops as dead code)."""
    _, got = jax_run
    tag = f"{arch}_p_1x2"
    assert port_flops[tag]["flops"] == pytest.approx(got["flops"][tag],
                                                     rel=0.01)


def _tokens_for(tm, i, shape):
    return torch.from_numpy(np.random.default_rng(20 + i).integers(
        0, tm.vocab_size, shape))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_on_a_mesh(arch):
    """The recurrent blocks' mesh route: the float forward within the
    float bar of the one-device forward, the ``abfp_ref`` forward bit for
    bit, at (1, 2) and (1, 4)."""
    tm, _, tp = _pair(arch)
    toks = _tokens_for(tm, 0, (4, 24))
    with torch.no_grad():
        one = forward(tp, toks, tm)[0]
        ref = forward(tp, toks, tm, Numerics(QREF, prng.PRNGKey(3)))[0]
        for shape in ((1, 2), (1, 4)):
            mesh = make_host_mesh(*shape, "cpu")
            got = forward(tp, toks, tm, mesh=mesh)[0]
            assert float((got - one).abs().max()) <= 1e-4, shape
            got = forward(tp, toks, tm, Numerics(QREF, prng.PRNGKey(3)),
                          mesh=mesh)[0]
            assert torch.equal(got, ref), shape


@pytest.mark.parametrize("arch,shape", DECODE,
                         ids=[f"{a}-{_tag(m)}" for a, m in DECODE])
def test_decode_step_on_a_mesh(arch, shape):
    """Three decode ticks after a prefill, with and without the mesh:
    float logits and every state tensor within the float bar; in
    ``abfp_ref`` bit for bit where the attention splits by heads (a
    head-dim split sums the scores in another f32 order, as GSPMD's
    all-reduce does, and may move an ABFP code)."""
    from repro_torch.core.tree import leaves
    from repro_torch.models.lm import (clone_state, decode_step,
                                       init_decode_state, prefill)
    tm, _, tp = _pair(arch)
    mesh = make_host_mesh(*shape, "cpu")
    by_heads = (tm.num_heads % shape[1] == 0
                and tm.num_kv_heads % shape[1] == 0)
    with torch.no_grad():
        st0 = init_decode_state(tm, 4, 32, device="cpu")
        prefill(tp, st0, _tokens_for(tm, 1, (4, 6)),
                torch.tensor([6, 3, 5, 0]), tm)
        for q in (QuantConfig(mode="float"), QREF):
            a, b = clone_state(st0), clone_state(st0)
            for i in range(3):
                tok = _tokens_for(tm, 2 + i, (4,))
                la, _ = decode_step(tp, a, tok, tm,
                                    Numerics(q, prng.PRNGKey(i)))
                lb, _ = decode_step(tp, b, tok, tm,
                                    Numerics(q, prng.PRNGKey(i)), mesh=mesh)
                if q.mode == "float":
                    assert float((la - lb).abs().max()) <= 1e-4
                elif by_heads:
                    assert torch.equal(la, lb)
            if q.mode == "float":
                for x, y in zip(leaves(a), leaves(b)):
                    torch.testing.assert_close(x, y, rtol=0, atol=1e-4)
