"""Training, DNF and model checkpoints of the recurrent and hybrid families
against the JAX package's, on the CPU.

The analogues of ``tests/test_torch_train.py`` and
``tests/test_torch_dnf.py`` on the recurrentgemma-2b smoke config cut to 5
layers (the (R, R, A) pattern leaves the remainder layers ``extra/0`` and
``extra/1``) and the xlstm-350m smoke config (2 layers), f32, d_model 128,
with the JAX parameters carried across by ``from_jax_params``, token
batches made with numpy from a seed and the same PRNG keys on both sides
(the port's threefry chain).  Bars:

  * ``make_train_step`` over 3 steps (float and remat with AdamW; QAT
    ``abfp_ref``, tile 32, with SGD): each step's loss and ``grad_norm``
    and the final parameters against JAX's, to the per-case bars of
    ``STEP_CASES``;
  * the gradients of the float loss against ``jax.grad`` leaf by leaf
    (rtol = atol = ``GRAD_TOL``), and every leaf's gradient nonzero;
  * remat (QAT, noise on): the layers run under ``torch.utils.checkpoint``
    and recompute their forward in the backward; loss and gradients equal
    the same forward's without the checkpoints bit for bit;
  * one ``make_dnf_train_step`` step (AdamW) with histograms fitted to
    the same samples on both sides: loss within rtol 1e-5, every weight
    moved;
  * ``make_train_step(donate=True)`` (the driver's in-place step) equal
    to the functional step bit for bit;
  * ``checkpoint.save_params`` / ``restore_params``: JAX's ``validate``
    and ``restore`` take the port's model checkpoint (``extra/r`` included)
    into JAX's ``init_params`` tree bit for bit, and the port restores
    JAX's;
  * ``launch.train --arch xlstm-350m --reduced --device cpu`` saves and
    resumes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.core.dnf as JD
import repro.optim as jopt
from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.training.finetune import make_dnf_train_step as j_make_dnf_step
from repro.training.train_lib import TrainConfig as JTrainConfig
from repro.training.train_lib import chunked_cross_entropy as j_chunked_ce
from repro.training.train_lib import make_train_step as j_make_train_step
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import smoke_config
from repro_torch.core import dnf as TD
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.tree import leaves
from repro_torch.launch import train as train_cli
from repro_torch.models import Numerics, forward, init_params, lm
from repro_torch.models.convert import from_jax_params
from repro_torch.training import (
    TrainConfig,
    chunked_cross_entropy,
    make_dnf_train_step,
    make_train_step,
)
from repro_torch.training.train_lib import value_and_grad

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

LAYERS = {"recurrentgemma-2b": 5, "xlstm-350m": 2}
QAT = dict(mode="abfp_ref", tile_width=32, gain=8.0, noise_lsb=0.5)
B, S = 2, 24
GRAD_TOL = 1e-4
# case: (quant, remat, optimizer, loss rtol, grad_norm rtol, parameter
# atol).  Float: the bars of ``tests/test_torch_train.py``'s float cases
# (rtol 1e-5; Adam's first step moves an element with a near-eps gradient
# by up to lr on a last-bit difference, so the parameters are held to lr
# with at most one element in 10,000 past rtol = atol = 1e-5).  QAT: the
# two forwards differ in the last f32 bit, which moves a rare activation
# code (``tests/test_torch_recurrent_forward.py``) and the ABFP outputs
# after it, and a recurrent state carries a moved code to every later
# token; over three SGD steps from one start the parameters' last bits
# part, and the codes with them (measured on xlstm: step 2's grad_norm
# 1.5 % apart).  So each QAT step starts from JAX's parameters of the step
# before (SGD holds no state), and its bars are test_torch_train.py's QAT
# bars.
STEP_CASES = {
    "float": ("float", False, "adamw", 1e-5, 1e-5, None),
    "remat": ("float", True, "adamw", 1e-5, 1e-5, None),
    "qat": ("abfp_ref", False, "sgd", 2e-3, 5e-3, 4e-4),
}


def _configs(arch, **kw):
    kw = dict(num_layers=LAYERS[arch], **kw)
    return (dataclasses.replace(j_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in LAYERS:
        jm, tm = _configs(arch)
        jp = j_init_params(jax.random.PRNGKey(0), jm)
        out[arch] = (jp, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                         device="cpu"))
    return out


def _key(seed):
    k = prng.fold_in(prng.PRNGKey(seed), 5)
    return jnp.asarray(k, jnp.uint32), k


def _tokens(seed, b=B, s=S + 1):
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(
        np.int32)


def _optimizers(name):
    if name == "adamw":
        return jopt.AdamW(jopt.constant(1e-3)), optim.AdamW(
            optim.constant(1e-3)), 1e-3
    return jopt.SGD(jopt.constant(1e-2)), optim.SGD(optim.constant(1e-2)), \
        1e-2


def _assert_params_close(got, want_jax, tm, lr, p_atol=None):
    want = leaves(from_jax_params(jax.tree.map(np.asarray, want_jax), tm,
                                  device="cpu"))
    for g, w in zip(leaves(got), want):
        d = (g.detach() - w).abs()
        if p_atol is not None:
            assert float(d.max()) <= p_atol, float(d.max())
            continue
        off = int((d > 1e-5 + 1e-5 * w.abs()).sum())
        assert off <= -(-d.numel() // 10_000), (off, float(d.max()))
        assert float(d.max()) <= lr


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("arch", list(LAYERS))
def test_train_step_matches_jax(models, arch, case):
    mode, remat, oname, loss_rtol, gn_rtol, p_atol = STEP_CASES[case]
    jm, tm = _configs(arch, remat=remat)
    jp, tp = models[arch]
    qkw = QAT if mode == "abfp_ref" else dict(mode="float")
    jo, to, lr = _optimizers(oname)
    j_init, j_step = j_make_train_step(
        jm, jo, JTrainConfig(quant=JQuantConfig(**qkw)))
    t_init, t_step = make_train_step(
        tm, to, TrainConfig(quant=QuantConfig(**qkw)), device="cpu")
    j_step = jax.jit(j_step)
    js, ts = j_init(jp), t_init(tp)
    for i in range(3):
        toks = _tokens(30 + i)
        jk, tk = _key(10 + i)
        if mode == "abfp_ref" and i:
            ts = ts._replace(params=from_jax_params(
                jax.tree.map(np.asarray, js.params), tm, device="cpu"))
        js, jmet = j_step(js, {"tokens": jnp.asarray(toks)}, jk)
        ts, tmet = t_step(ts, {"tokens": toks}, tk)
        print(f"{arch} {case} step {i}: loss {float(tmet['loss']):.7f} / "
              f"{float(jmet['loss']):.7f}, grad_norm "
              f"{float(tmet['grad_norm']):.6f} / "
              f"{float(jmet['grad_norm']):.6f}")
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=loss_rtol)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=gn_rtol)
    assert int(ts.step) == int(js.step) == 3
    _assert_params_close(ts.params, js.params, tm, lr, p_atol)


@pytest.mark.parametrize("oname", ["adamw", "sgd"])
def test_donated_step_equals_functional_step(oname):
    """``make_train_step(donate=True)`` (``update_``, in place, the
    driver's step) gives the functional step's losses, parameters and
    optimizer state bit for bit over 2 steps, AdamW with its global-norm
    clip and SGD; it writes into the state it was given."""
    _, tm = _configs("recurrentgemma-2b")
    to = _optimizers(oname)[1]
    res = []
    for donate in (False, True):
        init, step = make_train_step(tm, to, TrainConfig(), device="cpu",
                                     donate=donate)
        st = init(init_params(3, tm, device="cpu"))
        first = st
        for i in range(2):
            st, met = step(st, {"tokens": _tokens(50 + i)}, _key(i)[1])
        res.append((st, float(met["loss"]), first))
    (sf, lf, ff), (sd, ld, fd) = res
    assert lf == ld
    for a, b in zip(leaves(sf.params) + leaves(sf.opt_state),
                    leaves(sd.params) + leaves(sd.opt_state)):
        assert torch.equal(a, b)
    assert leaves(fd.params)[0] is leaves(sd.params)[0]
    assert not torch.equal(leaves(ff.params)[0], leaves(sf.params)[0])


def _t_loss(tm, quant):
    def fn(tree, toks, key):
        nx = Numerics(quant, key)
        hidden, aux = forward(tree, toks[:, :-1], tm, nx, return_hidden=True)
        loss = chunked_cross_entropy(tree, hidden, toks[:, 1:], tm, nx)
        return loss, loss, aux
    return fn


@pytest.mark.parametrize("arch", list(LAYERS))
def test_gradients_match_jax_grad(models, arch):
    jm, tm = _configs(arch)
    jp, tp = models[arch]
    toks = _tokens(40)

    def j_loss(p):
        hidden, _ = j_forward(p, jnp.asarray(toks[:, :-1]), jm,
                              return_hidden=True)
        from repro.models.layers import Numerics as JNumerics
        return j_chunked_ce(p, hidden, jnp.asarray(toks[:, 1:]), jm,
                            JNumerics(JQuantConfig(mode="float")))

    jl, jg = jax.value_and_grad(j_loss)(jp)
    tl, _, tg = value_and_grad(_t_loss(tm, QuantConfig(mode="float")), tp,
                               torch.from_numpy(toks).long(), None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = leaves(from_jax_params(jax.tree.map(np.asarray, jg), tm,
                                  device="cpu"))
    for g, w in zip(leaves(tg), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        assert float(g.abs().max()) > 0


def test_remat_recompute_draws_the_same_noise(models, monkeypatch):
    """QAT (abfp_ref, noise on) with ``remat`` on the hybrid: every layer
    (RG-LRU, windowed attention, remainder) runs under
    ``torch.utils.checkpoint``; the loss and the gradients equal those of
    the same forward without the checkpoints bit for bit."""
    _, tm = _configs("recurrentgemma-2b", remat=True)
    tp = models["recurrentgemma-2b"][1]
    fn = _t_loss(tm, QuantConfig(**QAT))
    toks = torch.from_numpy(_tokens(12)).long()
    want = value_and_grad(fn, tp, toks, prng.PRNGKey(7))
    calls = []
    real = lm.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(lm, "checkpoint", counted)
    got = value_and_grad(fn, tp, toks, prng.PRNGKey(7))
    assert len(calls) == tm.num_layers
    monkeypatch.setattr(lm, "checkpoint", lambda f, *a, **kw: f(*a))
    plain = value_and_grad(fn, tp, toks, prng.PRNGKey(7))
    for res in (got, plain):
        assert torch.equal(res[0], want[0])
    for a, b in zip(leaves(want[2]), leaves(got[2])):
        assert torch.equal(a, b)
    for a, b in zip(leaves(want[2]), leaves(plain[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(LAYERS))
def test_dnf_step_matches_jax(models, arch):
    jm, tm = _configs(arch)
    jp, tp = models[arch]
    rng = np.random.default_rng(9)
    samples = [(rng.laplace(size=(3000,)) * 0.05 * (i + 1)).astype(np.float32)
               for i in range(tm.num_layers)]
    jh = JD.NoiseHistogram.stack([JD.NoiseHistogram.fit(v) for v in samples])
    th = TD.NoiseHistogram.stack([TD.NoiseHistogram.fit(v) for v in samples])
    toks = _tokens(10)
    jk, tk = _key(12)
    j_init, j_step = j_make_dnf_step(jm, jopt.AdamW(jopt.constant(1e-3)), jh)
    t_init, t_step = make_dnf_train_step(tm, optim.AdamW(optim.constant(1e-3)),
                                         th, device="cpu")
    js, jmet = jax.jit(j_step)(j_init(jp), {"tokens": jnp.asarray(toks)}, jk)
    ts, tmet = t_step(t_init(tp), {"tokens": toks}, tk)
    print(f"{arch} DNF loss port {float(tmet['loss']):.7f} JAX "
          f"{float(jmet['loss']):.7f}")
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _assert_params_close(ts.params, js.params, tm, 1e-3)
    for a, b in zip(leaves(ts.params), leaves(tp)):
        assert not torch.equal(a, b)


def test_model_checkpoint_with_remainder_layers_both_ways(models, tmp_path):
    jm, tm = _configs("recurrentgemma-2b")
    jp, tp = models["recurrentgemma-2b"]
    assert len(jp["extra"]) == 2
    path = ckpt.save_params(str(tmp_path / "port"), 3, tp, tm,
                            extra={"data_step": 3})
    assert jckpt.validate(path)
    jgot, step, _ = jckpt.restore(str(tmp_path / "port"), jp)
    assert step == 3
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))
    jckpt.save(str(tmp_path / "jax"), 5, jp)
    got, step, _ = ckpt.restore_params(str(tmp_path / "jax"),
                                       init_params(1, tm, device="cpu"), tm)
    assert step == 5
    for a, b in zip(leaves(got), leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_driver_saves_and_resumes_xlstm(tmp_path, capsys):
    common = ["--arch", "xlstm-350m", "--reduced", "--device", "cpu",
              "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
              "--ckpt-every", "2"]
    first = train_cli.main(common + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[train] checkpoint ->" in out and "resumed" not in out
    assert ckpt.all_steps(str(tmp_path)) == [2, 4]
    second = train_cli.main(common + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert second["start_step"] == 4 and len(second["losses"]) == 2
    assert np.isfinite(first["losses"] + second["losses"]
                       + second["grad_norms"]).all()
