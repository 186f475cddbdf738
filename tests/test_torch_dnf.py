"""The port's Differential Noise Finetuning against the JAX package's.

The analogues of ``tests/test_dnf.py`` on the smollm-360m smoke config (2
layers, d_model 128, f32), with the JAX parameters carried across by
``from_jax_params``, histograms fitted to the same numpy samples on both
sides, and the same PRNG keys (the port's threefry chain).

Bars:
  * ``NoiseHistogram.sample`` equals JAX's bit for bit for the same key
    (several keys, shapes, one layer of a stacked capture);
  * ``capture_differential_noise`` fits the same histogram (exact);
  * ``forward(dnf=...)``: logits within rtol = atol = 1e-5 of JAX's (f32
    sum order), with and without ``remat``;
  * one ``make_dnf_train_step`` step (AdamW, lr ``LR``) with and without
    ``layer_mask``: loss within rtol 1e-5; parameters within rtol = atol =
    1e-5 but for at most one element in each started 10,000, and every
    element within one step (lr).  Adam's first step divides each gradient
    element by its own magnitude, so an element whose gradient is near
    eps moves by up to lr on an f32 last-bit difference of the gradient
    (measured: 1 of 16,384 elements of one leaf off, by 2.4e-5 / 5.6e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dnf as J
from repro.configs import smoke_config as j_smoke_config
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.optim import AdamW as JAdamW
from repro.optim import constant as j_constant
from repro.training.finetune import make_dnf_train_step as j_make_dnf_step
from repro_torch.configs import smoke_config
from repro_torch.core import dnf as T
from repro_torch.core import prng
from repro_torch.core.tree import leaves
from repro_torch.models import forward
from repro_torch.models.convert import from_jax_params
from repro_torch.optim import AdamW, constant
from repro_torch.training import make_dnf_train_step

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "smollm-360m"
B, S = 2, 16
LR = 1e-3


def _key(seed):
    k = prng.fold_in(prng.PRNGKey(seed), 11)
    return jnp.asarray(k, jnp.uint32), k


def _samples(seed, n_layers=2):
    rng = np.random.default_rng(seed)
    return [(rng.laplace(size=(3000,)) * 0.05 * (i + 1)).astype(np.float32)
            for i in range(n_layers)]


def _hists(seed, n_layers=2):
    s = _samples(seed, n_layers)
    return (J.NoiseHistogram.stack([J.NoiseHistogram.fit(v) for v in s]),
            T.NoiseHistogram.stack([T.NoiseHistogram.fit(v) for v in s]))


@pytest.mark.parametrize("shape", [(5,), (3, 17, 40), (2, 16, 128)])
def test_sample_equals_jax_bit_for_bit(shape):
    jh, th = _hists(0, n_layers=3)
    for seed in range(6):
        jk, tk = _key(seed)
        for li in range(3):
            want = np.asarray(jh.layer(li).sample(jk, shape))
            got = th.layer(li).sample(tk, shape)
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.view(np.int32))


def test_sample_stays_inside_the_histogram():
    _, th = _hists(1)
    h = th.layer(0)
    xi = h.sample(prng.PRNGKey(3), (4000,))
    assert float(xi.min()) >= float(h.edges[0])
    assert float(xi.max()) <= float(h.edges[-1])


def test_inject_keeps_gradients():
    jh, th = _hists(2)
    y = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
    y.requires_grad_(True)
    jk, tk = _key(4)
    out = T.inject(y, th.layer(1), tk)
    want = np.asarray(J.inject(jnp.asarray(y.detach().numpy()), jh.layer(1),
                               jk))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    (out * 2.0).sum().backward()
    torch.testing.assert_close(y.grad, torch.full_like(y, 2.0))
    assert T.inject(y, None, tk) is y


def test_capture_differential_noise_matches_jax():
    rng = np.random.default_rng(5)
    f = rng.normal(size=(4, 8, 32)).astype(np.float32)
    q = f + (rng.laplace(size=f.shape) * 0.01).astype(np.float32)
    jh = J.capture_differential_noise(jnp.asarray(f), jnp.asarray(q))
    th = T.capture_differential_noise(torch.from_numpy(f), torch.from_numpy(q))
    np.testing.assert_array_equal(th.edges.numpy(), np.asarray(jh.edges))
    np.testing.assert_array_equal(th.cum.numpy(), np.asarray(jh.cum))
    np.testing.assert_array_equal(th.std.numpy(), np.asarray(jh.std))


@pytest.fixture(scope="module")
def model():
    jm = j_smoke_config(ARCH)
    tm = smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return jm, tm, jp, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                       device="cpu")


def _tokens(seed, s=S + 1):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 512, size=(B, s)).astype(np.int32)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_with_dnf_matches_jax(remat, model):
    jm, tm, jp, tp = model
    jm = dataclasses.replace(jm, remat=remat)
    tm = dataclasses.replace(tm, remat=remat)
    jh, th = _hists(6, tm.num_layers)
    toks = _tokens(7, S)
    jk, tk = _key(8)
    jl, _ = j_forward(jp, jnp.asarray(toks), jm, dnf=jh, dnf_key=jk)
    tl, _ = forward(tp, torch.from_numpy(toks), tm, dnf=th, dnf_key=tk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    plain, _ = forward(tp, torch.from_numpy(toks), tm)
    assert float((plain - tl).abs().max()) > 1e-3      # the noise went in


def assert_params_close(t_params, j_params, tm, lr):
    """The port's parameters against JAX's (converted): rtol = atol = 1e-5
    but for at most one element in each started 10,000 of a leaf, and
    every element within one step ``lr``."""
    want = leaves(from_jax_params(jax.tree.map(np.asarray, j_params), tm,
                                  device="cpu"))
    got = leaves(t_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().float().numpy(), w.float().numpy()
        d = np.abs(g - w)
        off = int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
        assert off <= -(-d.size // 10_000), (off, d.size, d.max())
        assert d.max() <= lr, d.max()


@pytest.mark.parametrize("mask", [None, [True, False]])
def test_dnf_train_step_matches_jax(mask, model):
    jm, tm, jp, tp = model
    jh, th = _hists(9, tm.num_layers)
    toks = _tokens(10)
    jk, tk = _key(12)
    j_init, j_step = j_make_dnf_step(jm, JAdamW(j_constant(LR)), jh,
                                     layer_mask=mask)
    t_init, t_step = make_dnf_train_step(tm, AdamW(constant(LR)), th,
                                         layer_mask=mask, device="cpu")
    js, jmet = jax.jit(j_step)(j_init(jp), {"tokens": jnp.asarray(toks)}, jk)
    ts, tmet = t_step(t_init(tp), {"tokens": toks}, tk)
    print(f"mask {mask}: loss port {float(tmet['loss']):.7f} "
          f"JAX {float(jmet['loss']):.7f}")
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert int(ts.step) == int(js.step) == 1
    assert_params_close(ts.params, js.params, tm, LR)


def test_layer_mask_silences_masked_layers(model):
    """A masked layer's histogram collapses to zero edges: its draws are
    exactly 0, so with every layer masked the DNF forward is the FLOAT
    forward."""
    _, tm, _, tp = model
    _, th = _hists(13, tm.num_layers)
    zero = T.NoiseHistogram(edges=th.edges * 0.0, cum=th.cum,
                            mean=th.mean * 0.0, std=th.std * 0.0)
    toks = torch.from_numpy(_tokens(14, S))
    a, _ = forward(tp, toks, tm, dnf=zero, dnf_key=prng.PRNGKey(1))
    b, _ = forward(tp, toks, tm)
    assert torch.equal(a, b)
