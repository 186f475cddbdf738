"""The port's expert-parallel MoE (``models.moe.moe_block_sharded``)
against the JAX package's, on the CPU: the analogue of
``tests/test_distributed.py``'s ``test_moe_sharded_matches_local``.

The JAX package's ``moe_block_sharded`` is a ``shard_map`` over a (data,
model) mesh; it runs in a subprocess on eight forced placeholder CPU
devices, on the granite-moe-1b-a400m smoke config's MoE weights
(``init_moe`` from key 0) and a numpy input from a seed.  The port
computes the same shards one by one on the CPU (a virtual mesh).  At
capacity factors 8.0 (nothing dropped), 1.25 (the production factor:
GShard-style dropping under load imbalance) and 0.5 (a cut below the mean
load, so every shard drops pairs and folds them into its last group), at
meshes (2, 4) and (1, 4):

  * the kept (token, expert) pairs of every (data, expert) shard equal
    JAX's (JAX's kept pairs are read with its own routing and a stable
    ``jnp.argsort`` in the subprocess);
  * ``y`` within ``Y_TOL``, ``aux`` within ``AUX_RTOL`` relative;
  * against the port's one-shard ``moe_block``, the bars of
    ``test_moe_sharded_matches_local``: at 8.0 ``y`` within 2e-2 and aux
    within 5e-2 relative (the mean of per-data-shard load-balance losses
    is not the whole batch's), at 1.25 under a quarter of the tokens
    moved by more than 5 %.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models.layers import Numerics

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"
MESHES = [(2, 4), (1, 4)]
FACTORS = [8.0, 1.25, 0.5]
Y_TOL = 1e-5
AUX_RTOL = 1e-6
X_SHAPE = (8, 16)

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.core.abfp import QuantConfig
from repro.models import moe as moe_lib
from repro.models.layers import Numerics

out_path, b, s = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mcfg0 = smoke_config("granite-moe-1b-a400m")
params = moe_lib.init_moe(jax.random.PRNGKey(0), mcfg0)
x = np.random.default_rng(1).normal(size=(b, s, mcfg0.d_model)).astype(
    np.float32)
nx = Numerics(QuantConfig(mode="float"))
res = {"x": x, **{k: np.asarray(v) for k, v in params.items()}}
y1, a1 = moe_lib.moe_block(params, jnp.asarray(x), mcfg0, nx)
res["y_local"], res["aux_local"] = np.asarray(y1), np.float32(a1)
pairs = {}
k, e = mcfg0.experts_per_token, mcfg0.num_experts
for cf in (8.0, 1.25, 0.5):
    mcfg = dataclasses.replace(mcfg0, capacity_factor=cf)
    for dp, tp in ((2, 4), (1, 4)):
        mesh = jax.make_mesh((dp, tp), ("data", "model"))
        y, aux = jax.jit(lambda p, v: moe_lib.moe_block_sharded(
            p, v, mcfg, nx, mesh))(params, jnp.asarray(x))
        tag = f"{cf}_{dp}x{tp}"
        res["y_" + tag], res["aux_" + tag] = np.asarray(y), np.float32(aux)
        # The kept pairs, by the local function's own steps.
        bl, e_local = b // dp, e // tp
        t = bl * s
        cap = min(int((t * k / tp) * cf) + 1, t * k)
        kept = []
        for db in range(dp):
            xf = jnp.asarray(x[db * bl:(db + 1) * bl].reshape(t, -1))
            _, eids, _ = moe_lib._route(xf, params["router"], mcfg)
            for sh in range(tp):
                local = eids - sh * e_local
                mine = (local >= 0) & (local < e_local)
                flat = jnp.where(mine, local, e_local).reshape(-1)
                rows = np.asarray(jnp.argsort(flat)[:cap])
                flat_e = np.asarray(eids).reshape(-1)
                kept.append(sorted(
                    [int(db * t + r // k), int(flat_e[r])] for r in rows
                    if sh * e_local <= flat_e[r] < (sh + 1) * e_local))
        pairs[tag] = kept
np.savez(out_path, **res)
print("PAIRS " + json.dumps(pairs))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's values (one subprocess): weights, input, the
    one-shard block, and per (factor, mesh) y, aux and kept pairs."""
    out = tmp_path_factory.mktemp("moe_sharded") / "jax.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                        *map(str, X_SHAPE)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("PAIRS ")]
    assert line, r.stdout + r.stderr
    data = dict(np.load(out))
    return data, json.loads(line[0][6:])


def _port_inputs(data):
    params = {k: torch.from_numpy(data[k]) for k in ("router", "wi", "wg",
                                                      "wo")}
    return params, torch.from_numpy(data["x"])


def _mcfg(cf):
    return dataclasses.replace(smoke_config(ARCH), capacity_factor=cf)


def _port_pairs(params, x, mcfg, dp, tp):
    """The port's kept (global token, expert) pairs of every (data,
    expert) shard, in JAX's shard order."""
    b, s, d = x.shape
    bl, k = b // dp, mcfg.experts_per_token
    e_local, t = mcfg.num_experts // tp, bl * s
    cap = min(int((t * k / tp) * mcfg.capacity_factor) + 1, t * k)
    out = []
    for db in range(dp):
        xf = x[db * bl:(db + 1) * bl].reshape(t, d)
        gates, eids, _ = moe._route(xf, params["router"], mcfg)
        for sh in range(tp):
            rows, ids, _ = moe._local_pairs(gates, eids, sh * e_local,
                                            e_local, cap)
            flat_e = eids.reshape(-1)
            out.append(sorted(
                [db * t + int(r) // k, int(flat_e[r])]
                for r, i in zip(rows.tolist(), ids.tolist()) if i < e_local))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "1x4"])
@pytest.mark.parametrize("cf", FACTORS)
def test_moe_sharded_matches_jax(jax_run, cf, shape):
    data, pairs = jax_run
    params, x = _port_inputs(data)
    mcfg = _mcfg(cf)
    tag = f"{cf}_{shape[0]}x{shape[1]}"
    got = _port_pairs(params, x, mcfg, *shape)
    assert got == pairs[tag]
    n_pairs = x.shape[0] * x.shape[1] * mcfg.experts_per_token
    if cf != 1.25:
        assert (sum(map(len, got)) < n_pairs) == (cf < 1.0)
    y, aux = moe.moe_block_sharded(params, x, mcfg,
                                   Numerics(QuantConfig(mode="float")),
                                   make_host_mesh(*shape, "cpu"))
    assert y.dtype == x.dtype and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), data["y_" + tag], rtol=Y_TOL,
                               atol=Y_TOL)
    np.testing.assert_allclose(float(aux), float(data["aux_" + tag]),
                               rtol=AUX_RTOL)


def test_moe_sharded_matches_local(jax_run):
    """The port's expert-parallel block against its one-shard block (the
    reference's own test, on the port): nothing dropped at 8.0; at the
    production factor 1.25 under a quarter of the tokens moved."""
    data, _ = jax_run
    params, x = _port_inputs(data)
    nx = Numerics(QuantConfig(mode="float"))
    mesh = make_host_mesh(2, 4, "cpu")
    y_loc, aux_loc = moe.moe_block(params, x, smoke_config(ARCH), nx)
    np.testing.assert_allclose(y_loc.numpy(), data["y_local"], rtol=1e-5,
                               atol=1e-5)
    y_sh, aux_sh = moe.moe_block_sharded(params, x, _mcfg(8.0), nx, mesh)
    np.testing.assert_allclose(y_loc.numpy(), y_sh.numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(float(aux_loc), float(aux_sh), rtol=5e-2)
    y_dp, _ = moe.moe_block_sharded(params, x, _mcfg(1.25), nx, mesh)
    frac = float(torch.mean(torch.any(
        (y_dp - y_sh).abs() > 0.05 * (1 + y_sh.abs()), dim=-1).float()))
    assert frac < 0.25, frac


def test_moe_sharded_ignores_nx_and_refuses_uneven_splits(jax_run):
    """The JAX route's experts are float under any quant mode: an ABFP
    ``Numerics`` gives the float route's output bit for bit.  Experts
    that do not split over the model axis, or a batch that does not
    split over the data axis, raise."""
    data, _ = jax_run
    params, x = _port_inputs(data)
    mcfg, mesh = _mcfg(1.25), make_host_mesh(2, 4, "cpu")
    want = moe.moe_block_sharded(params, x, mcfg,
                                 Numerics(QuantConfig(mode="float")), mesh)
    abfp = Numerics(QuantConfig(mode="abfp_kernel", tile_width=32, gain=8.0,
                                noise_lsb=0.5), 3)
    got = moe.moe_block_sharded(params, x, mcfg, abfp, mesh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="experts"):
        moe.moe_block_sharded(params, x, mcfg, abfp,
                              make_host_mesh(1, 3, "cpu"))
    with pytest.raises(ValueError, match="batch"):
        moe.moe_block_sharded(params, x[:3], mcfg, abfp, mesh)
