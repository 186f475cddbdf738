"""The port's sharding rules (``repro_torch.distributed.sharding``) and
tensor-parallel predicates (``kernels.ops.tp_col_quantum``,
``tp_shardable``) against the JAX package's, on the CPU: the analogues of
``tests/test_distributed.py``'s spec tests.

The port holds per-layer lists where the JAX package stacks ``groups/j``
(and ``encoder/layers``) along a leading scan axis, so the spec of a port
leaf must equal JAX's spec of the same path with that axis dropped (and,
for the port's list of packed MoE experts, the expert axis as well).
Every spec function is held to JAX's on every registered arch's smoke
params (float and packed) and decode state, on fake meshes (data, model)
= (4, 2), (1, 2), (2, 4) and (1, 8).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import PackedWeight as JPackedWeight
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.distributed import sharding as jsh
from repro.kernels import ops as jops
from repro.models import init_params as j_init_params
from repro.models.packing import pack_model_params as j_pack_model_params
from repro.serving.runners import runner_for as j_runner_for
from repro_torch.configs import list_archs, smoke_config
from repro_torch.core.abfp import PackedWeight, QuantConfig
from repro_torch.distributed import sharding as tsh
from repro_torch.kernels import ops
from repro_torch.kernels.ops import ColumnShards
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.models.convert import _groups
from repro_torch.models.packing import pack_model_params
from repro_torch.serving.runners import runner_for

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCHS = sorted(list_archs())
MESHES = [(4, 2), (1, 2), (2, 4), (1, 8)]
FUSED = QuantConfig(mode="abfp_fused", tile_width=32, gain=4.0,
                    noise_lsb=0.5)


class _FakeMesh:
    """What the JAX package's spec functions read of a mesh."""

    axis_names = ("data", "model")

    def __init__(self, dp, tp):
        self.shape = {"data": dp, "model": tp}


def _jq(q):
    return JQuantConfig(mode=q.mode, tile_width=q.tile_width, gain=q.gain,
                        noise_lsb=q.noise_lsb)


@pytest.fixture(scope="module")
def zoo():
    """{arch: (JAX config, JAX param shapes, port config, port params)}."""
    out = {}
    for a in ARCHS:
        jm = j_smoke_config(a)
        jp = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jm))
        tm = smoke_config(a)
        out[a] = (jm, jp, tm, init_params(0, tm, device="cpu"))
    return out


def _leaves(tree, path=()):
    """(path, leaf) of a port tree (``PackedWeight`` / ``ColumnShards`` are
    leaves; a spec ``P`` too)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _jax_place(path, mcfg):
    """The JAX path of a port leaf's path and the leading axes its JAX
    leaf has beyond the port's (the scan axis; a packed expert's axis)."""
    glen, ng = _groups(mcfg)
    head, drop = list(path), 0
    if head[0] in ("layers", "enc"):
        li = int(head[1])
        if li < glen * ng:
            head[:2] = [head[0] if head[0] == "enc" else "groups",
                        str(li % glen)]
            drop = 1
        else:
            head[:2] = ["extra", str(li - glen * ng)]
    elif head[:2] == ["encoder", "layers"]:
        head = head[:2] + head[3:]
        drop = 1
    if len(head) >= 3 and head[-3] == "moe" and head[-1].isdigit():
        head, drop = head[:-1], drop + 1        # a packed MoE expert
    return head, drop


def _jget(tree, path):
    for p in path:
        tree = tree[int(p)] if isinstance(tree, (list, tuple)) else tree[p]
    return tree


def _same(tspec, jspec, drop, where):
    assert isinstance(jspec, JP), where
    assert tuple(tspec) == tuple(jspec)[drop:], (where, tspec, jspec)


def _check_tree(ttree, jtree, mcfg, skip=()):
    n = 0
    for path, tspec in _leaves(ttree):
        if tspec is None or path[-1] in skip:
            continue
        jpath, drop = _jax_place(path, mcfg)
        jspec = _jget(jtree, jpath)
        if isinstance(tspec, PackedWeight):
            assert isinstance(jspec, JPackedWeight), path
            _same(tspec.codes, jspec.codes, drop, path)
            _same(tspec.scales, jspec.scales, drop, path)
            assert (tspec.gains is None) == (jspec.gains is None), path
            if tspec.gains is not None:
                _same(tspec.gains, jspec.gains, drop, path)
        else:
            _same(tspec, jspec, drop, path)
        n += 1
    assert n > 0
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_trees_equal_jax(zoo, arch):
    jm, jp, tm, tp = zoo[arch]
    _check_tree(tsh.param_spec_tree(tp), jsh.param_spec_tree(jp), tm)
    _check_tree(tsh.abfp_param_spec_tree(tp), jsh.abfp_param_spec_tree(jp),
                tm)
    for dp, tp_ in MESHES:
        tmesh, jmesh = make_host_mesh(dp, tp_, "cpu"), _FakeMesh(dp, tp_)
        _check_tree(tsh.param_spec_tree(tp, tmesh),
                    jsh.param_spec_tree(jp, jmesh), tm)
        _check_tree(tsh.abfp_param_spec_tree(tp, tmesh),
                    jsh.abfp_param_spec_tree(jp, jmesh), tm)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_param_spec_trees_equal_jax(zoo, arch):
    """Float trees at float / abfp_kernel / no quant, and the packed tree
    (abfp_fused, per-tile gains) at its quant and without one; the packed
    QKV concatenation has no JAX leaf."""
    jm, jp, tm, tp = zoo[arch]
    jpk = jax.eval_shape(lambda p: j_pack_model_params(p, _jq(FUSED), jm),
                         jp)
    tpk = pack_model_params(tp, FUSED, tm)
    kernel = dataclasses.replace(FUSED, mode="abfp_kernel")
    for dp, tp_ in MESHES:
        tmesh, jmesh = make_host_mesh(dp, tp_, "cpu"), _FakeMesh(dp, tp_)
        for q in (QuantConfig(mode="float"), kernel, None):
            _check_tree(tsh.serving_param_spec_tree(tp, tmesh, q),
                        jsh.serving_param_spec_tree(
                            jp, jmesh, None if q is None else _jq(q)), tm)
        for q in (FUSED, None):
            _check_tree(tsh.serving_param_spec_tree(tpk, tmesh, q),
                        jsh.serving_param_spec_tree(
                            jpk, jmesh, None if q is None else _jq(q)),
                        tm, skip=("qkv",))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_spec_trees_equal_jax(zoo, arch):
    """``serving_state_spec_tree`` on the engine's decode state (and the
    paged one), ``decode_state_spec_tree`` on the decoder layers' unpaged
    state (JAX's rule reads the stacked encoder K/V as unstacked, so
    ``enc`` has no port counterpart there; the port's page pools hold one
    more page, the scratch page, so their data-axis divisibility is not
    JAX's)."""
    jm, _, tm, _ = zoo[arch]
    jr, tr = j_runner_for(jm), runner_for(tm)
    kws = [{}]
    if tr.paged_ok:
        kws.append(dict(page_size=8, pool_pages=6))
    for kw in kws:
        js = jax.eval_shape(lambda: jr.init_state(4, 32, **kw))
        ts = tr.init_state(4, 32, "cpu", **kw)
        for dp, tp_ in MESHES:
            tmesh, jmesh = make_host_mesh(dp, tp_, "cpu"), _FakeMesh(dp, tp_)
            _check_tree(tsh.serving_state_spec_tree(ts, tmesh),
                        jsh.serving_state_spec_tree(js, jmesh), tm)
            if kw:
                continue
            dec = {k: v for k, v in ts.items() if k != "enc"}
            _check_tree(tsh.decode_state_spec_tree(dec, tmesh),
                        jsh.decode_state_spec_tree(
                            {k: v for k, v in js.items() if k != "enc"},
                            jmesh), tm)


def test_validate_batch_and_zero1_specs_equal_jax():
    shapes = [(51865, 512), (512, 64), (1, 8), (8, 8), (7,), (6, 4, 2)]
    specs = [("model", None), (None, "model"), (("data",), None),
             (("data", "model"), None), ("data",), (None,),
             (None, ("data", "model"), "model")]
    for dp, tp_ in MESHES:
        tmesh, jmesh = make_host_mesh(dp, tp_, "cpu"), _FakeMesh(dp, tp_)
        for shape in shapes:
            assert tuple(tsh.batch_spec(tmesh, shape)) == tuple(
                jsh.batch_spec(jmesh, shape))
            for sp in specs:
                assert tuple(tsh.validate_spec(tsh.P(*sp), shape, tmesh)) \
                    == tuple(jsh.validate_spec(JP(*sp), shape, jmesh))
                assert tuple(tsh.zero1_spec(tsh.P(*sp), shape, tmesh)) == \
                    tuple(jsh.zero1_spec(JP(*sp), shape, jmesh))


def test_mesh_reads_as_jax_meshes_do():
    mesh = make_host_mesh(2, 4, "cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model")
    assert mesh.size == 8 and mesh.devices.shape == (2, 4)
    assert mesh.device_set() == {torch.device("cpu")}
    assert ops.tp_size(mesh) == 4 and ops.tp_size(None) == 1
    with pytest.raises(ValueError):
        make_host_mesh(0, 2, "cpu")


@pytest.mark.parametrize("mode", ["float", "abfp_ref", "abfp_kernel",
                                  "abfp_packed", "abfp_fused"])
@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tp_col_quantum_and_shardable_equal_jax(mode, noise, tp):
    q = QuantConfig(mode=mode, tile_width=32, gain=4.0, noise_lsb=noise)
    jq = _jq(q)
    tmesh, jmesh = make_host_mesh(1, tp, "cpu"), _FakeMesh(1, tp)
    for packed in (False, True):
        assert ops.tp_col_quantum(q, packed, tp) == \
            jops.tp_col_quantum(jq, packed, tp)
    for cols in (128, 130, 256, 384, 512, 1024):
        w = torch.zeros(64, cols)
        jw = jax.ShapeDtypeStruct((64, cols), np.float32)
        assert ops.tp_shardable(w, q, tmesh) == \
            jops.tp_shardable(jw, jq, jmesh), cols
        if mode != "float":
            from repro.core.abfp import pack_abfp_weight as j_pack
            from repro_torch.core.abfp import pack_abfp_weight
            qp = dataclasses.replace(q, mode="abfp_packed")
            pw = pack_abfp_weight(w, qp)
            jpw = jax.eval_shape(lambda a: j_pack(a, _jq(qp)), jw)
            assert ops.tp_shardable(pw, q, tmesh) == \
                jops.tp_shardable(jpw, jq, jmesh), cols
    stacked = torch.zeros(2, 64, 512)
    assert not ops.tp_shardable(stacked, q, tmesh)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_packs_split_codes_kcodes_and_scales_together(zoo, tp):
    """Every packed weight the serving placement shards becomes ``tp``
    local packs whose codes, kernel-layout codes and scales are the same
    columns of the whole pack's, gains whole; every one it keeps whole
    has a replicated spec; the QKV concatenation is built per shard when
    wq, wk and wv all shard, and dropped otherwise."""
    from repro_torch.core.abfp import kernel_layout

    _, _, tm, tp_params = zoo["tinyllama-1.1b"]
    mesh = make_host_mesh(1, tp, "cpu")
    whole = pack_model_params(tp_params, FUSED, tm)
    placed = pack_model_params(tp_params, FUSED, tm, mesh=mesh)
    specs = dict(_leaves(tsh.serving_param_spec_tree(whole, mesh, FUSED)))
    n_sharded = 0
    for path, leaf in _leaves(placed):
        if path[-1] == "qkv" or not isinstance(
                leaf, (PackedWeight, ColumnShards)):
            continue
        pw = _jget(whole, path)
        spec = specs[path].codes
        assert tuple(specs[path].scales) == tuple(spec)
        if isinstance(leaf, PackedWeight):
            assert spec[-1] is None, path
            assert torch.equal(leaf.codes, pw.codes)
            continue
        n_sharded += 1
        assert spec[-1] == "model" and pw.n_padded % (tp * 128) == 0
        assert (leaf.n_cols, leaf.n_padded) == (pw.n_cols, pw.n_padded)
        c = pw.n_padded // tp
        for t, loc in enumerate(leaf.shards):
            sl = slice(t * c, (t + 1) * c)
            assert torch.equal(loc.codes, pw.codes[:, sl])
            assert torch.equal(loc.kcodes, pw.kcodes[:, sl])
            assert torch.equal(loc.kcodes, kernel_layout(loc.codes))
            assert torch.equal(loc.scales, pw.scales[:, sl])
            assert torch.equal(loc.gains, pw.gains)
            assert leaf.grid(t) == (t * c // 128, pw.n_padded // 128)
    assert n_sharded > 0
    for lp in placed["layers"]:
        attn = lp["attn"]
        split = all(isinstance(attn[w], ColumnShards)
                    for w in ("wq", "wk", "wv"))
        assert ("qkv" in attn) == split
        if split:
            assert len(attn["qkv"]) == tp
            for t, pq in enumerate(attn["qkv"]):
                assert pq.pws == tuple(attn[w].shards[t]
                                       for w in ("wq", "wk", "wv"))
