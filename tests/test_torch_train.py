"""The port's training path against the JAX package's.

The analogues of ``tests/test_train_driver.py`` on the smollm-360m smoke
config (2 layers, d_model 128, f32): the JAX parameters carried across by
``from_jax_params``, token batches made with numpy from a seed, and the
same PRNG keys on both sides (the port's threefry chain).

Bars:
  * ``batch_at_step`` equals JAX's bit for bit (2 seeds x 8 steps, and
    the full 49,152-token vocabulary);
  * ``cross_entropy`` / ``chunked_cross_entropy``: rtol 1e-6;
  * AdamW, SGD, ``clip_by_global_norm`` and the schedules on the same
    gradients: f32 values within rtol 1e-5 / atol 1e-7 (``b ** step`` and
    ``cos`` in f32 by two libraries), bf16 parameters within one bf16 ULP;
  * ``make_train_step`` over 3 steps (float with AdamW; remat,
    microbatches 2 and bf16 compression with AdamW; QAT ``abfp_ref`` and
    int8 compression with SGD): each step's loss and ``grad_norm`` and
    the final parameters against JAX's, to the per-case bars in
    ``STEP_CASES`` (see there why QAT's are wider);
  * the checkpoint format: JAX's ``validate`` accepts what the port
    wrote and the port's accepts (and restores) what JAX wrote;
  * ``launch.train --reduced --device cpu`` saves and resumes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.optim as jopt
from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.data import batch_at_step as j_batch_at_step
from repro.models import init_params as j_init_params
from repro.models.layers import Numerics as JNumerics
from repro.training.train_lib import TrainConfig as JTrainConfig
from repro.training.train_lib import chunked_cross_entropy as j_chunked_ce
from repro.training.train_lib import cross_entropy as j_ce
from repro.training.train_lib import make_train_step as j_make_train_step
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.tree import leaves
from repro_torch.data import DataConfig, SyntheticDataset, batch_at_step
from repro_torch.launch import train as train_cli
from repro_torch.models import Numerics
from repro_torch.models.convert import from_jax_params
from repro_torch.training import (
    TrainConfig,
    chunked_cross_entropy,
    cross_entropy,
    make_train_step,
)

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "smollm-360m"
QAT = dict(mode="abfp_ref", tile_width=32, gain=8.0, noise_lsb=0.5)


def _key(seed):
    k = prng.fold_in(prng.PRNGKey(seed), 5)
    return jnp.asarray(k, jnp.uint32), k


@pytest.fixture(scope="module")
def model():
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return jm, tm, jp, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                       device="cpu")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_at_step_equals_jax(seed):
    jc, tc = JDataConfig(512, 32, 4, seed), DataConfig(512, 32, 4, seed)
    for step in range(8):
        want = np.asarray(j_batch_at_step(jc, step)["tokens"])
        got = batch_at_step(tc, step)["tokens"]
        assert got.dtype == torch.int32 and tuple(got.shape) == (4, 33)
        np.testing.assert_array_equal(got.numpy(), want)


def test_full_vocab_batches_and_dataset_equal_jax():
    jc, tc = JDataConfig(49152, 128, 4, 0), DataConfig(49152, 128, 4, 0)
    jd, td = JSyntheticDataset(jc, start_step=2), SyntheticDataset(tc, 2)
    for _ in range(3):
        np.testing.assert_array_equal(next(td)["tokens"].numpy(),
                                      np.asarray(next(jd)["tokens"]))
    assert td.step == jd.step == 5


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("mode,chunk", [("float", 8), ("float", 256),
                                        ("abfp_ref", 8)])
def test_chunked_cross_entropy_matches_jax(mode, chunk, model):
    """Two chunks of 8, and the S % chunk fallback (one chunk of 16); the
    head under fold 999,983 of the loss's Numerics."""
    jm, tm, jp, tp = model
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(2, 16, tm.d_model)).astype(np.float32)
    labels = rng.integers(0, tm.vocab_size, size=(2, 16)).astype(np.int32)
    kw = QAT if mode == "abfp_ref" else dict(mode="float")
    jk, tk = _key(3)
    want = j_chunked_ce(jp, jnp.asarray(hidden), jnp.asarray(labels), jm,
                        JNumerics(JQuantConfig(**kw), jk), chunk=chunk)
    got = chunked_cross_entropy(tp, torch.from_numpy(hidden),
                                torch.from_numpy(labels), tm,
                                Numerics(QuantConfig(**kw), tk), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------


def _opt_tree(rng):
    return {"a": rng.normal(size=(8, 16)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(4, 4)).astype(np.float32)]}


def _to_torch(tree, bf16_leaf=True):
    out = {"a": torch.from_numpy(tree["a"]),
           "b": [torch.from_numpy(tree["b"][0]),
                 torch.from_numpy(tree["b"][1])]}
    if bf16_leaf:
        out["b"][1] = out["b"][1].to(torch.bfloat16)
    return out


def _to_jax(tree):
    return {"a": jnp.asarray(tree["a"]),
            "b": [jnp.asarray(tree["b"][0]),
                  jnp.asarray(tree["b"][1], jnp.bfloat16)]}


def _assert_tree_close(got, want):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w.astype(jnp.float32))
        g = g.detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizers_match_jax(name):
    rng = np.random.default_rng(4)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    for g in grads:
        g["a"] *= 3.0                          # global norm > 1: clipped
    if name == "adamw":
        jo = jopt.AdamW(jopt.cosine_one_cycle(1e-2, 10), weight_decay=0.01)
        to = optim.AdamW(optim.cosine_one_cycle(1e-2, 10), weight_decay=0.01)
    else:
        jo = jopt.SGD(jopt.exponential_decay(1e-2, 0.3, 2))
        to = optim.SGD(optim.exponential_decay(1e-2, 0.3, 2))
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(_to_jax(g), js, jp)
        tp, ts = to.update(_to_torch(g), ts, tp)
    assert int(ts.step) == int(js.step) == 3
    _assert_tree_close(ts.master, js.master)
    _assert_tree_close(ts[1], js[1])           # mu / velocity
    assert tp["b"][1].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["b"][1].float().numpy(),
                               np.asarray(jp["b"][1].astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-5, atol=1e-7)


def test_schedules_and_norms_match_jax():
    pairs = [(jopt.cosine_one_cycle(1e-3, 20), optim.cosine_one_cycle(1e-3,
                                                                      20)),
             (jopt.exponential_decay(1e-2, 0.3, 3),
              optim.exponential_decay(1e-2, 0.3, 3)),
             (jopt.constant(5e-4), optim.constant(5e-4))]
    for jf, tf in pairs:
        for step in range(0, 25):
            want = float(jf(jnp.int32(step)))
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6)
    rng = np.random.default_rng(6)
    tree = _opt_tree(rng)
    tt = _to_torch(tree, bf16_leaf=False)
    jt = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(optim.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=1e-6)
    for c, jc in zip(leaves(optim.clip_by_global_norm(tt, 0.5)),
                     jax.tree.leaves(jopt.clip_by_global_norm(jt, 0.5))):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                                   atol=1e-8)


# ---------------------------------------------------------------------------
# make_train_step against JAX's, 3 steps
# ---------------------------------------------------------------------------

# case: (quant, remat, train-config keywords, optimizer, loss rtol,
# grad_norm rtol, parameter atol).  The float cases' parameters agree to
# rtol = atol = 1e-5 but for at most one element in each started 10,000
# of a leaf (Adam's first step moves an element with a near-eps gradient
# by up to lr on a last-bit difference: measured 3 of 426,624), and every
# element within ``lr``.  QAT: the two forwards' activations differ in the
# last f32 bit (rope, rsqrt, softmax), which moves a rare activation code
# and the ABFP outputs after it (``tests/test_torch_eval.py``); measured
# loss 2.6e-5 (step 0) to 5.2e-4 relative, grad_norm 1.2e-3, parameters
# 9.6e-5 after 3 SGD steps at lr 1e-2.  int8 compression rounds g / scale,
# so a last-bit gradient difference can move one int8 code; SGD keeps that
# linear (measured 1.1e-5).
STEP_CASES = {
    "float": ("float", False, {}, "adamw", 1e-5, 1e-5, None),
    "remat": ("float", True, {}, "adamw", 1e-5, 1e-5, None),
    "microbatches": ("float", False, dict(microbatches=2), "adamw", 1e-5,
                     1e-5, None),
    "bf16": ("float", False, dict(compression="bf16"), "adamw", 1e-5, 1e-5,
             None),
    "int8": ("float", False, dict(compression="int8"), "sgd", 1e-5, 1e-3,
             4e-5),
    "qat": ("abfp_ref", False, {}, "sgd", 2e-3, 5e-3, 4e-4),
}


def _optimizers(name):
    if name == "adamw":
        return jopt.AdamW(jopt.constant(1e-3)), optim.AdamW(
            optim.constant(1e-3)), 1e-3
    return jopt.SGD(jopt.constant(1e-2)), optim.SGD(optim.constant(1e-2)), \
        1e-2


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case, model):
    jm, tm, jp, tp = model
    mode, remat, tkw, oname, loss_rtol, gn_rtol, p_atol = STEP_CASES[case]
    jm = dataclasses.replace(jm, remat=remat)
    tm = dataclasses.replace(tm, remat=remat)
    qkw = QAT if mode == "abfp_ref" else dict(mode="float")
    jo, to, lr = _optimizers(oname)
    j_init, j_step = j_make_train_step(
        jm, jo, JTrainConfig(quant=JQuantConfig(**qkw), **tkw))
    t_init, t_step = make_train_step(
        tm, to, TrainConfig(quant=QuantConfig(**qkw), **tkw), device="cpu")
    j_step = jax.jit(j_step)
    js, ts = j_init(jp), t_init(tp)
    rng = np.random.default_rng(7)
    for i in range(3):
        toks = rng.integers(1, tm.vocab_size, size=(4, 33)).astype(np.int32)
        jk, tk = _key(10 + i)
        js, jmet = j_step(js, {"tokens": jnp.asarray(toks)}, jk)
        ts, tmet = t_step(ts, {"tokens": toks}, tk)
        print(f"{case} step {i}: loss {float(tmet['loss']):.7f} / "
              f"{float(jmet['loss']):.7f}, grad_norm "
              f"{float(tmet['grad_norm']):.6f} / "
              f"{float(jmet['grad_norm']):.6f}")
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=loss_rtol)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=gn_rtol)
        assert float(tmet["aux_loss"]) == 0.0
    assert int(ts.step) == int(js.step) == 3
    want = leaves(from_jax_params(jax.tree.map(np.asarray, js.params), tm,
                                  device="cpu"))
    for g, w in zip(leaves(ts.params), want):
        d = (g.detach() - w).abs()
        if p_atol is not None:
            assert float(d.max()) <= p_atol, float(d.max())
            continue
        off = int((d > 1e-5 + 1e-5 * w.abs()).sum())
        assert off <= -(-d.numel() // 10_000), (off, float(d.max()))
        assert float(d.max()) <= lr


def test_remat_recompute_draws_the_same_noise(model, monkeypatch):
    """QAT (abfp_ref, noise on) with ``remat``: the layers run under
    ``torch.utils.checkpoint`` and recompute their forward in the
    backward; every noise draw comes from a key, so the loss and the
    gradients equal those of the same forward without the checkpoints
    bit for bit."""
    from repro_torch.models import forward, lm
    from repro_torch.training.train_lib import value_and_grad

    _, tm, _, tp = model
    tm = dataclasses.replace(tm, remat=True)
    quant = QuantConfig(**QAT)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        1, 512, (2, 17)))

    def loss_fn(tree, t, key):
        nx = Numerics(quant, key)
        hidden, aux = forward(tree, t[:, :-1], tm, nx, return_hidden=True)
        loss = chunked_cross_entropy(tree, hidden, t[:, 1:], tm, nx)
        return loss, loss, aux

    want = value_and_grad(loss_fn, tp, toks, prng.PRNGKey(7))
    calls = []
    real = lm.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(lm, "checkpoint", counted)
    got = value_and_grad(loss_fn, tp, toks, prng.PRNGKey(7))
    assert len(calls) == tm.num_layers
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: fn(*a))
    plain = value_and_grad(loss_fn, tp, toks, prng.PRNGKey(7))
    for res in (got, plain):
        assert torch.equal(res[0], want[0])
    for a, b in zip(leaves(want[2]), leaves(plain[2])):
        assert torch.equal(a, b)


def test_qat_gradients_reach_every_weight(model):
    _, tm, _, tp = model
    init, step = make_train_step(tm, optim.SGD(optim.constant(1e-2)),
                                 TrainConfig(quant=QuantConfig(**QAT)),
                                 device="cpu")
    s0 = init(tp)
    toks = np.random.default_rng(8).integers(1, 512, (2, 17)).astype(
        np.int32)
    s1, met = step(s0, {"tokens": toks}, prng.PRNGKey(1))
    assert np.isfinite(float(met["loss"]))
    names_moved = [bool((a - b).abs().max() > 0)
                   for a, b in zip(leaves(s1.params), leaves(s0.params))]
    assert all(names_moved)


# ---------------------------------------------------------------------------
# Checkpoints: the JAX package's on-disk format
# ---------------------------------------------------------------------------


def _ckpt_tree(rng):
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "h": rng.normal(size=(2, 5)).astype(np.float32)},
            "count": np.int32(7)}


def test_checkpoint_the_jax_package_validates_and_restores(tmp_path):
    rng = np.random.default_rng(9)
    tree = _ckpt_tree(rng)
    ttree = {"params": {"w": torch.from_numpy(tree["params"]["w"]),
                        "h": torch.from_numpy(tree["params"]["h"])
                        .to(torch.bfloat16)},
             "count": torch.tensor(7, dtype=torch.int32)}
    jtree = {"params": {"w": jnp.asarray(tree["params"]["w"]),
                        "h": jnp.asarray(tree["params"]["h"], jnp.bfloat16)},
             "count": jnp.int32(7)}
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    for s in (1, 2, 3, 4):
        path = ckpt.save(d_port, s, ttree, keep_last_k=2,
                         extra={"data_step": s})
        jckpt.save(d_jax, s, jtree, keep_last_k=2, extra={"data_step": s})
    assert ckpt.all_steps(d_port) == jckpt.all_steps(d_jax) == [3, 4]
    assert ckpt.latest_step(d_port) == 4
    assert jckpt.validate(path)
    assert ckpt.validate(os.path.join(d_jax, "step_0000000004"))
    # Same manifests (leaf names, dtypes, shapes, hash), same leaf bytes.
    import json
    mp = json.load(open(os.path.join(path, "manifest.json")))
    mj = json.load(open(os.path.join(d_jax, "step_0000000004",
                                     "manifest.json")))
    assert mp == mj
    # Each side restores the other's checkpoint.
    got, step, extra = ckpt.restore(d_jax, ttree)
    assert step == 4 and extra == {"data_step": 4}
    for g, w in zip(leaves(got), leaves(ttree)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    jgot, jstep, _ = jckpt.restore(d_port, jtree)
    assert jstep == 4
    for g, w in zip(jax.tree.leaves(jgot), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))


def test_checkpoint_restore_skips_a_corrupt_latest(tmp_path):
    t = {"a": torch.arange(6, dtype=torch.float32)}
    d = str(tmp_path)
    ckpt.save(d, 1, t)
    path = ckpt.save(d, 2, {"a": t["a"] + 1})
    os.remove(os.path.join(path, "leaf_00000.npy"))
    assert not ckpt.validate(path)
    got, step, _ = ckpt.restore(d, t)
    assert step == 1 and torch.equal(got["a"], t["a"])


# ---------------------------------------------------------------------------
# Serve steps, the restart policy and the driver
# ---------------------------------------------------------------------------


def test_serve_steps_are_forward_and_decode_step(model):
    from repro_torch.models import decode_step, forward, init_decode_state
    from repro_torch.training import make_serve_steps

    _, tm, _, tp = model
    quant = QuantConfig(mode="abfp_kernel", tile_width=32, noise_lsb=0.5)
    prefill_fn, decode_fn, init_state = make_serve_steps(tm, quant,
                                                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        1, 512, (2, 8)).astype(np.int32))
    key = prng.PRNGKey(2)
    assert torch.equal(prefill_fn(tp, toks, key),
                       forward(tp, toks, tm, Numerics(quant, key))[0])
    st = init_state(2, 16)
    want, _ = decode_step(tp, init_decode_state(tm, 2, 16, device="cpu"),
                          toks[:, 0], tm, Numerics(quant, key))
    got, st = decode_fn(tp, st, toks[:, 0], key)
    assert torch.equal(got, want) and int(st["position"][0]) == 1


def test_restart_policy_matches_jax():
    from repro.distributed.fault import RestartPolicy as JRestartPolicy
    from repro_torch.distributed import RestartPolicy

    j, t = JRestartPolicy(max_restarts=3, window_sec=10.0), \
        RestartPolicy(max_restarts=3, window_sec=10.0)
    for now in (0.0, 1.0, 2.0, 3.0, 9.5, 10.5, 12.0, 13.0, 25.0):
        assert t.should_restart(now) == j.should_restart(now), now




def test_train_driver_saves_and_resumes(tmp_path, capsys):
    common = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    first = train_cli.main(common + ["--steps", "8"])
    out = capsys.readouterr().out
    assert "[train] checkpoint ->" in out and "resumed" not in out
    assert len(first["losses"]) == 8
    assert ckpt.all_steps(str(tmp_path)) == [4, 8]
    second = train_cli.main(common + ["--steps", "10", "--quant", "qat"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 8" in out
    assert second["start_step"] == 8 and len(second["losses"]) == 2
    assert all(np.isfinite(second["losses"] + second["grad_norms"]))
    assert ckpt.latest_step(str(tmp_path)) == 10
