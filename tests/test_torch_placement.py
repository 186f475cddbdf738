"""The port's placements on a mesh (``distributed.sharding``'s
``named_sharding_tree``, ``zero1_state_sharding``, ``shard_params`` and
``shard_decode_state``) against the JAX package's, on the CPU.

Every registered arch's smoke params (and decode state) at the fake
meshes (data, model) = (4, 2), (1, 2), (2, 4) and (1, 8), as
``tests/test_torch_sharding.py`` holds the other spec trees: the spec of
a port leaf equals JAX's spec of the same path with the scan axis (and a
packed expert's axis) dropped.

  * ``named_sharding_tree`` and ``zero1_state_sharding``: the specs of
    JAX's ``NamedSharding``s on an ``AbstractMesh`` of the same shape.
    ZeRO-1 reads a stacked leaf's shape with its scan axis; where JAX
    puts 'data' on that axis the port's leaf keeps the rest;
  * ``shard_params`` and ``shard_decode_state``: the specs that JAX's own
    placements leave on every array (``.sharding.spec``), read in one
    subprocess on eight forced placeholder CPU devices; the port's
    placed trees hold the same values on the mesh's one device.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import smoke_config as j_smoke_config
from repro.distributed import sharding as jsh
from repro.models import init_params as j_init_params
from repro_torch.configs import list_archs, smoke_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.serving.runners import runner_for
from test_torch_sharding import _check_tree, _jax_place, _leaves

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(list_archs())
MESHES = [(4, 2), (1, 2), (2, 4), (1, 8)]


def _specs(tree):
    """A tree of ``NamedSharding`` -> its tree of specs (the port's dicts
    and lists, or JAX's pytree)."""
    if isinstance(tree, tsh.NamedSharding):
        return tree.spec
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_specs(v) for v in tree]
    return tree.spec


@pytest.fixture(scope="module")
def zoo():
    out = {}
    for a in ARCHS:
        jm = j_smoke_config(a)
        jp = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jm))
        tm = smoke_config(a)
        out[a] = (jp, tm, init_params(0, tm, device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_named_and_zero1_shardings_equal_jax(zoo, arch):
    jp, tm, tp = zoo[arch]
    for dp, tp_ in MESHES:
        tmesh = make_host_mesh(dp, tp_, "cpu")
        jmesh = AbstractMesh((dp, tp_), ("data", "model"))
        named = tsh.named_sharding_tree(tp, tmesh)
        assert all(ns.mesh is tmesh for _, ns in _leaves(named))
        _check_tree(_specs(named),
                    _specs(jsh.named_sharding_tree(jp, jmesh)), tm)
        _check_tree(_specs(tsh.zero1_state_sharding(tp, tmesh)),
                    _specs(jsh.zero1_state_sharding(jp, jmesh)), tm)


def test_zero1_can_shard_the_scan_axis_like_jax():
    """A stacked leaf whose largest divisible replicated axis is JAX's
    scan axis: JAX puts 'data' there, and the port's per-layer leaf keeps
    the rest of the spec (replicated)."""
    tree = {"layers": [{"norm1": {"scale": torch.zeros(3)}}
                       for _ in range(8)]}
    jtree = {"groups": [{"norm1": {"scale": jax.ShapeDtypeStruct(
        (8, 3), np.float32)}}]}
    mesh, jmesh = make_host_mesh(4, 2, "cpu"), AbstractMesh(
        (4, 2), ("data", "model"))
    want = jsh.zero1_state_sharding(jtree, jmesh)["groups"][0]["norm1"][
        "scale"].spec
    assert tuple(want) == ("data", None)
    for lp in tsh.zero1_state_sharding(tree, mesh)["layers"]:
        assert tuple(lp["norm1"]["scale"].spec) == (None,)


_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from repro.configs import list_archs, smoke_config
from repro.distributed import sharding as jsh
from repro.models import init_params
from repro.serving.runners import runner_for


def entry(e):
    return list(e) if isinstance(e, tuple) else e


def specs(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = [entry(e) for e in leaf.sharding.spec]
    return out


res = {}
for a in sorted(list_archs()):
    m = smoke_config(a)
    p = init_params(jax.random.PRNGKey(0), m)
    st = runner_for(m).init_state(4, 32)
    for dp, tp in ((4, 2), (1, 2), (2, 4), (1, 8)):
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:dp * tp]).reshape(
            dp, tp), ("data", "model"))
        res[f"{a} {dp}x{tp}"] = {
            "params": specs(jsh.shard_params(p, mesh)),
            "state": specs(jsh.shard_decode_state(st, mesh))}
print("SPECS " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_placed():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=ROOT)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("SPECS ")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][6:])


def _placed_specs_equal(tspecs, jspecs, mcfg):
    """Every port leaf's spec against the spec JAX's placement left on the
    same path's array (its leading stacked axes dropped)."""
    n = 0
    for path, tspec in _leaves(tspecs):
        jpath, drop = _jax_place(path, mcfg)
        want = jspecs["/".join(jpath)][drop:]
        got = [list(e) if isinstance(e, tuple) else e for e in tspec]
        assert got == want, (path, tspec, want)
        n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_and_decode_state_place_like_jax(zoo, jax_placed, arch):
    _, tm, tp = zoo[arch]
    state = runner_for(tm).init_state(4, 32, "cpu")
    for dp, tp_ in MESHES:
        mesh = make_host_mesh(dp, tp_, "cpu")
        want = jax_placed[f"{arch} {dp}x{tp_}"]
        _placed_specs_equal(_specs(tsh.named_sharding_tree(tp, mesh)),
                            want["params"], tm)
        _placed_specs_equal(tsh.serving_state_spec_tree(state, mesh),
                            want["state"], tm)
        for placed, tree in ((tsh.shard_params(tp, mesh), tp),
                             (tsh.shard_decode_state(state, mesh), state)):
            pairs = list(zip(_leaves(placed), _leaves(tree)))
            assert pairs
            for (p1, a), (p2, b) in pairs:
                assert p1 == p2 and a.device == torch.device("cpu")
                assert torch.equal(a, b)


def test_placements_refuse_a_mesh_over_several_devices(zoo):
    _, _, tp = zoo["smollm-360m"]
    devs = np.array([[torch.device("cpu"), torch.device("meta")]],
                    dtype=object)
    mesh = tsh.Mesh(devs, ("data", "model"))
    for fn in (tsh.shard_params, tsh.shard_decode_state):
        with pytest.raises(NotImplementedError, match="multi-card"):
            fn(tp, mesh)
