"""The training mesh: ``forward(..., mesh=)`` and ``make_train_step(...,
mesh=)`` against the JAX package's, on the CPU.

Under a mesh the JAX package sends every MoE layer through its
expert-parallel ``moe_block_sharded`` (a ``shard_map`` over 'model' and
the data axis) and changes nothing else: the loss's ``Numerics`` carries
no mesh.  Its values come from one subprocess on eight forced placeholder
CPU devices, on the granite-moe-1b-a400m smoke config (init key 0, f32,
2 layers, 8 experts top-2) and token batches made with numpy from a seed;
the port gets the same weights through ``from_jax_params`` and the same
keys (its threefry chain).  The JAX mesh is a ``jax.sharding.Mesh``
(automatic axes): under ``jax.make_mesh``'s explicit axes this JAX raises
a ``ShardingTypeError`` in the head's backward (ROADMAP queue 3).

Bars (``tests/test_torch_train.py``'s and ``tests/test_torch_moe.py``'s):
  * the forward at (2, 4) and (1, 4): logits within 1e-5, aux within
    1e-6 relative;
  * two steps of ``make_train_step(mesh=(2, 4))``, float (AdamW), float
    with 2 microbatches and bf16 compression (AdamW), and QAT
    ``abfp_kernel`` (tile 32, gain 8, noise 0.5; SGD): each step's loss,
    aux and grad_norm within 1e-5 (float) and 2e-3 / 5e-3 (QAT: loss and
    aux / grad_norm; the attention projections and the head are ABFP,
    where a last-bit difference moves a rare activation code);
  * a dense arch (tinyllama-1.1b's smoke config) under a (2, 4) mesh
    takes the Megatron routes (every dense weight split over 'model' as
    GSPMD splits it under JAX's ``param_spec_tree``): its float forward
    within 1e-4 of JAX's GSPMD-compiled (2, 4) forward and two AdamW steps'
    loss and grad_norm within 1e-5 relative of JAX's (row-parallel sums
    reorder f32 sums, as GSPMD's do); its ``abfp_ref`` forward, whose ABFP
    spec tree splits columns only, bit-equal to the one-device forward;
  * port only: the donated mesh step
    equals the functional one bit for bit; at capacity factor 8.0 the
    mesh forward's logits are the one-device forward's within 1e-5, and
    its aux the mean of the data shards' own one-device losses within
    1e-6 (the mean of per-data-shard load-balance losses is not the
    whole batch's).
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
from repro.models import init_params as j_init_params
from repro_torch import optim
from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import forward
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import Numerics
from repro_torch.training import TrainConfig, make_train_step

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"
QAT = dict(mode="abfp_kernel", tile_width=32, gain=8.0, noise_lsb=0.5)
# case: (quant, train-config keywords, optimizer, loss / aux rtol,
# grad_norm rtol)
CASES = {
    "float": (dict(mode="float"), {}, "adamw", 1e-5, 1e-5),
    "microbatches_bf16": (dict(mode="float"),
                          dict(microbatches=2, compression="bf16"), "adamw",
                          1e-5, 1e-5),
    "qat_abfp_kernel": (QAT, {}, "sgd", 2e-3, 5e-3),
}
STEPS = 2
BATCH = (4, 17)

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.core.abfp import QuantConfig
from repro.models import forward, init_params
from repro.optim import optimizers as jopt
from repro.training.train_lib import TrainConfig, make_train_step

out_path, cases = sys.argv[1], json.loads(sys.argv[2])
b, s, steps = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
mcfg = smoke_config("granite-moe-1b-a400m")
params = init_params(jax.random.PRNGKey(0), mcfg)
toks = [np.random.default_rng(7 + i).integers(
    1, mcfg.vocab_size, (b, s)).astype(np.int32) for i in range(steps)]


def mesh(dp, tp):
    return jax.sharding.Mesh(np.array(jax.devices()[:dp * tp]).reshape(
        dp, tp), ("data", "model"))


res, mets = {}, {}
for dp, tp in ((2, 4), (1, 4)):
    m = mesh(dp, tp)
    lg, aux = jax.jit(lambda p, t: forward(p, t, mcfg, mesh=m))(
        params, jnp.asarray(toks[0][:, :-1]))
    res[f"logits_{dp}x{tp}"] = np.asarray(lg)
    res[f"aux_{dp}x{tp}"] = np.float32(aux)
m = mesh(2, 4)
# A dense arch compiled as GSPMD partitions it under param_spec_tree.
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.sharding import batch_spec, param_spec_tree
tcfg = smoke_config("tinyllama-1.1b")
tparams = init_params(jax.random.PRNGKey(0), tcfg)
psh = jax.tree.map(lambda sp: NamedSharding(m, sp),
                   param_spec_tree(tparams, m),
                   is_leaf=lambda x: isinstance(x, P))
rep = NamedSharding(m, P())
bsh = NamedSharding(m, batch_spec(m, toks[0].shape))
t0 = jnp.asarray(toks[0][:, :-1])
res["dense_logits"] = np.asarray(jax.jit(
    lambda p, t: forward(p, t, tcfg)[0],
    in_shardings=(psh, NamedSharding(m, batch_spec(m, t0.shape))))(
        jax.device_put(tparams, psh), t0))
init, step = make_train_step(tcfg, jopt.AdamW(jopt.constant(1e-3)),
                             TrainConfig())
st = init(tparams)
st_sh = type(st)(params=psh,
                 opt_state=jax.tree.map(lambda _: rep, st.opt_state),
                 ef=None, step=rep)
step = jax.jit(step, in_shardings=(st_sh, {"tokens": bsh}, rep),
               out_shardings=(st_sh, None))
st, mets["dense"] = jax.device_put(st, st_sh), []
for i in range(steps):
    key = jax.device_put(jax.random.fold_in(jax.random.PRNGKey(10 + i), 5),
                         rep)
    st, met = step(st, {"tokens": jax.device_put(jnp.asarray(toks[i]),
                                                 bsh)}, key)
    mets["dense"].append({k: float(v) for k, v in met.items()})
for name, (qkw, tkw, oname) in cases.items():
    opt = (jopt.AdamW(jopt.constant(1e-3)) if oname == "adamw"
           else jopt.SGD(jopt.constant(1e-2)))
    init, step = make_train_step(mcfg, opt,
                                 TrainConfig(quant=QuantConfig(**qkw), **tkw),
                                 mesh=m)
    step = jax.jit(step)
    st, mets[name] = init(params), []
    for i in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(10 + i), 5)
        st, met = step(st, {"tokens": jnp.asarray(toks[i])}, key)
        mets[name].append({k: float(v) for k, v in met.items()})
np.savez(out_path, **res)
print("METRICS " + json.dumps(mets))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train") / "jax.npz"
    cases = {k: (q, t, o) for k, (q, t, o, _, _) in CASES.items()}
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                        json.dumps(cases), *map(str, BATCH), str(STEPS)],
                       capture_output=True, text=True, timeout=900, env=env,
                       cwd=ROOT)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("METRICS ")]
    assert line, r.stdout + r.stderr
    return dict(np.load(out)), json.loads(line[0][8:])


def _pair(arch, **repl):
    jm = dataclasses.replace(j_smoke_config(arch), **repl)
    tm = dataclasses.replace(smoke_config(arch), **repl)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return tm, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                               device="cpu")


@pytest.fixture(scope="module")
def granite():
    return _pair(ARCH)


def _tokens(i, vocab):
    return np.random.default_rng(7 + i).integers(
        1, vocab, BATCH).astype(np.int32)


def _key(i):
    return prng.fold_in(prng.PRNGKey(10 + i), 5)


def _optimizer(name):
    return (optim.AdamW(optim.constant(1e-3)) if name == "adamw"
            else optim.SGD(optim.constant(1e-2)))


@pytest.mark.parametrize("shape", [(2, 4), (1, 4)], ids=["2x4", "1x4"])
def test_forward_on_a_mesh_matches_jax(jax_run, granite, shape):
    data, _ = jax_run
    tm, tp = granite
    toks = torch.from_numpy(_tokens(0, tm.vocab_size)[:, :-1])
    logits, aux = forward(tp, toks, tm, mesh=make_host_mesh(*shape, "cpu"))
    tag = f"{shape[0]}x{shape[1]}"
    np.testing.assert_allclose(logits.numpy(), data["logits_" + tag],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(data["aux_" + tag]),
                               rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_on_a_mesh_matches_jax(jax_run, granite, case):
    _, want = jax_run
    tm, tp = granite
    qkw, tkw, oname, rtol, gn_rtol = CASES[case]
    init, step = make_train_step(
        tm, _optimizer(oname), TrainConfig(quant=QuantConfig(**qkw), **tkw),
        device="cpu", mesh=make_host_mesh(2, 4, "cpu"))
    st = init(tp)
    for i in range(STEPS):
        st, met = step(st, {"tokens": _tokens(i, tm.vocab_size)}, _key(i))
        w = want[case][i]
        print(f"{case} step {i}: " + ", ".join(
            f"{k} {float(met[k]):.7f} / {w[k]:.7f}" for k in w))
        for k, bar in (("loss", rtol), ("aux_loss", rtol),
                       ("grad_norm", gn_rtol)):
            np.testing.assert_allclose(float(met[k]), w[k], rtol=bar)
        assert float(met["aux_loss"]) > 0.0
    assert int(st.step) == STEPS


def test_dense_arch_on_a_mesh_is_bit_equal(jax_run):
    """A dense arch under a (2, 4) mesh runs the Megatron routes: the
    ``abfp_ref`` forward (columns split, rows whole by the ABFP spec
    tree) is the one-device forward bit for bit; the float forward and
    two AdamW steps (rows split too) hold JAX's GSPMD mesh run's bars."""
    data, want = jax_run
    tm, tp = _pair("tinyllama-1.1b")
    mesh = make_host_mesh(2, 4, "cpu")
    toks = [_tokens(i, tm.vocab_size) for i in range(STEPS)]
    t0 = torch.from_numpy(toks[0][:, :-1])
    qref = QuantConfig(mode="abfp_ref", tile_width=32, gain=8.0,
                       noise_lsb=0.5)
    with torch.no_grad():
        a, b = (forward(tp, t0, tm, Numerics(qref, prng.PRNGKey(3)),
                        mesh=m)[0] for m in (None, mesh))
    assert torch.equal(a, b)
    logits, aux = forward(tp, t0, tm, mesh=mesh)
    np.testing.assert_allclose(logits.detach().numpy(),
                               data["dense_logits"], rtol=0, atol=1e-4)
    assert float(aux) == 0.0
    init, step = make_train_step(tm, _optimizer("adamw"), TrainConfig(),
                                 device="cpu", mesh=mesh)
    st = init(tp)
    for i in range(STEPS):
        st, met = step(st, {"tokens": toks[i]}, _key(i))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(met[k]),
                                       want["dense"][i][k], rtol=1e-5)


def test_donated_mesh_step_equals_functional_step(granite):
    """``donate=True`` under a mesh: the step updates the parameters and
    the optimizer state in place, to the functional step's bits."""
    tm, tp = granite
    mesh = make_host_mesh(2, 4, "cpu")
    out = []
    for donate in (False, True):
        init, step = make_train_step(tm, _optimizer("adamw"), TrainConfig(),
                                     device="cpu", mesh=mesh, donate=donate)
        st = init(tree_map(torch.clone, tp) if donate else tp)
        for i in range(STEPS):
            st, met = step(st, {"tokens": _tokens(i, tm.vocab_size)},
                           _key(i))
        out.append((float(met["loss"]), leaves(st.params)))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(x, y) for x, y in zip(out[0][1], out[1][1]))


def test_mesh_forward_against_the_one_device_forward():
    """At capacity factor 8.0 nothing is dropped: the mesh forward's
    logits are the one-device forward's within 1e-5 (the reference MoE
    test's bar is 2e-2), and its aux is the mean over the data shards of
    each shard's own one-device aux (within 1e-6 relative): at (1, 4) the
    whole batch's, at (2, 4) the mean of the two halves'."""
    tm, tp = _pair(ARCH, capacity_factor=8.0)
    toks = torch.from_numpy(_tokens(1, tm.vocab_size)[:, :-1])
    one_l, _ = forward(tp, toks, tm)
    for dp in (2, 1):
        lg, aux = forward(tp, toks, tm, mesh=make_host_mesh(dp, 4, "cpu"))
        np.testing.assert_allclose(lg.numpy(), one_l.numpy(), rtol=1e-5,
                                   atol=1e-5)
        rows = toks.shape[0] // dp
        want = sum(float(forward(tp, toks[i:i + rows], tm)[1])
                   for i in range(0, toks.shape[0], rows)) / dp
        np.testing.assert_allclose(float(aux), want, rtol=1e-6)
