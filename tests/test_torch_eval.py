"""The port's cacheless evaluation forward against the JAX package's.

``forward`` (teacher-forced, no cache), ``evaluate_abfp`` and DNF's
``capture_histograms`` on the smollm-360m smoke config (2 layers, d_model
128, f32), with the JAX parameters carried across by ``from_jax_params``
and the same noise keys on both sides (the port's threefry chain).  JAX's
Pallas kernels (``abfp_matmul_pallas``, ``flash_attention``) run in
interpret mode.  Tokens are made with numpy from a seed.

Bars:
  * ``float`` (flash attention off and on): logits within rtol = atol =
    1e-5 (f32 sum order);
  * ``abfp_kernel`` (tile 32, gain 8, noise 0.5, flash on), on every
    noise-key seed 0..7: logits max-abs difference below
    ``ABFP_PASS_TOL``, the bar of ``test_torch_model.py``'s forced passes.
    The two sides differ only in the last f32 bit of rope's sin/cos,
    rsqrt, softmax and the interpret-mode kernels' sum order; a rare
    one-ULP bf16 flip moves an activation code, and the 32 ABFP roundings
    downstream carry it to the logits;
  * the port's float ``forward`` equals its own ``prefill`` at each row's
    last real token (rtol = atol = 1e-5);
  * ``evaluate_abfp``: float accuracy equal; ABFP accuracy within
    ``ACC_TOL`` (two of the 124 predictions may part on a near tie);
  * ``capture_histograms``: per-layer std of dy within ``STD_RTOL``
    relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models.layers import Numerics as JNumerics
from repro.training.finetune import capture_histograms as j_capture
from repro.training.finetune import evaluate_abfp as j_evaluate
from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.dnf import NoiseHistogram, select_layers_by_std
from repro_torch.kernels import ops
from repro_torch.models import (
    Numerics,
    decode_step,
    forward,
    init_decode_state,
    lm_head_logits,
    prefill,
)
from repro_torch.models.convert import from_jax_params
from repro_torch.training import capture_histograms, evaluate_abfp

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "smollm-360m"
B, S = 2, 32
ABFP_PASS_TOL = 0.5
ACC_TOL = 2 / (B * (S - 1))
STD_RTOL = 1e-2


def _configs(flash=True):
    j = dataclasses.replace(j_smoke_config(ARCH), use_flash_attention=flash)
    t = dataclasses.replace(smoke_config(ARCH), use_flash_attention=flash)
    return j, t


@pytest.fixture(scope="module")
def params():
    jm, tm = _configs()
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")


def _quant(mode):
    if mode == "float":
        return JQuantConfig(mode="float"), QuantConfig(mode="float")
    kw = dict(mode=mode, tile_width=32, gain=8.0, noise_lsb=0.5)
    return JQuantConfig(**kw), QuantConfig(**kw)


def _tokens(seed, b=B, s=S, vocab=512):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(b, s)).astype(np.int32)


def _keys(seed):
    k = prng.PRNGKey(seed)
    return jnp.asarray(k, jnp.uint32), k


@pytest.mark.parametrize("flash", [False, True])
def test_float_forward_matches_jax(flash, params):
    jm, tm = _configs(flash)
    jp, tp = params
    toks = _tokens(1)
    jl, jaux = j_forward(jp, jnp.asarray(toks), jm)
    tl, taux = forward(tp, torch.from_numpy(toks), tm)
    assert tl.dtype == torch.float32 and tl.shape == (B, S, tm.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    assert float(taux) == float(jaux) == 0.0
    hidden, _ = forward(tp, torch.from_numpy(toks), tm, return_hidden=True)
    assert hidden.shape == (B, S, tm.d_model)
    torch.testing.assert_close(lm_head_logits(tp, hidden, tm), tl,
                               rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(8))
def test_abfp_kernel_forward_matches_jax(seed, params):
    jm, tm = _configs(flash=True)
    jq, tq = _quant("abfp_kernel")
    jp, tp = params
    toks = _tokens(100 + seed)
    jk, tk = _keys(seed)
    jl = np.asarray(j_forward(jp, jnp.asarray(toks), jm, JNumerics(jq, jk))[0])
    tl = forward(tp, torch.from_numpy(toks), tm, Numerics(tq, tk))[0].numpy()
    d = np.abs(jl - tl)
    print(f"seed {seed}: logits max-abs difference {d.max():.3g}, "
          f"{int((d > 1e-2).sum())}/{d.size} above 1e-2, argmax equal "
          f"{float((jl.argmax(-1) == tl.argmax(-1)).mean()):.3f}")
    assert d.max() < ABFP_PASS_TOL


@pytest.mark.parametrize("flash", [False, True])
def test_float_forward_equals_prefill(flash, params):
    _, tm = _configs(flash)
    _, tp = params
    toks = torch.from_numpy(_tokens(2))
    n = torch.tensor([S, S - 7], dtype=torch.int32)
    fl, _ = forward(tp, toks, tm)
    pl, _ = prefill(tp, init_decode_state(tm, B, S, device="cpu"), toks, n,
                    tm)
    want = fl[torch.arange(B), n.long() - 1]
    torch.testing.assert_close(pl, want, rtol=1e-5, atol=1e-5)


def test_forward_launches_no_kernel_on_the_cpu(params):
    _, tm = _configs(flash=True)
    _, tq = _quant("abfp_kernel")
    ops.reset_launch_counts()
    forward(params[1], torch.from_numpy(_tokens(3)), tm,
            Numerics(tq, prng.PRNGKey(0)))
    assert sum(ops.launch_counts().values()) == 0


def _greedy_batches(tp, tm, n_batches=2):
    """Half of each batch continues a random token greedily under the
    float model (float accuracy 1 on those rows), half is random."""
    out = []
    for i in range(n_batches):
        toks = _tokens(20 + i, s=S)
        st = init_decode_state(tm, B, S, device="cpu")
        tok = torch.from_numpy(toks[:, 0])
        for t in range(S - 1):
            logits, st = decode_step(tp, st, tok, tm)
            tok = logits.argmax(-1).to(torch.int32)
            toks[0, t + 1] = int(tok[0])
        out.append({"tokens": toks})
    return out


def test_evaluate_abfp_matches_jax(params):
    jm, tm = _configs(flash=True)
    jp, tp = params
    batches = _greedy_batches(tp, tm)
    jk, tk = _keys(5)
    accs = {}
    for mode in ("float", "abfp_kernel"):
        jq, tq = _quant(mode)
        want = j_evaluate(jp, [{"tokens": jnp.asarray(b["tokens"])}
                               for b in batches], jm, jq, key=jk)
        got = evaluate_abfp(tp, batches, tm, tq, key=tk)
        accs[mode] = (got, want)
    print(f"accuracy (port, JAX): {accs}")
    assert accs["float"][0] == accs["float"][1]
    assert accs["float"][0] >= 0.5          # the greedy rows are all right
    assert abs(accs["abfp_kernel"][0] - accs["abfp_kernel"][1]) <= ACC_TOL


def test_capture_histograms_matches_jax(params):
    jm, tm = _configs(flash=True)
    jp, tp = params
    toks = _tokens(7)
    jq, tq = _quant("abfp_kernel")
    jk, tk = _keys(3)
    jh, jstd = j_capture(jp, jnp.asarray(toks), jm, jq, key=jk)
    th, tstd = capture_histograms(tp, torch.from_numpy(toks), tm, tq, key=tk)
    print(f"per-layer dy std: port {tstd}, JAX {jstd}")
    assert len(tstd) == tm.num_layers
    np.testing.assert_allclose(tstd, jstd, rtol=STD_RTOL)
    assert th.edges.shape == tuple(jh.edges.shape)
    assert th.cum.shape == tuple(jh.cum.shape)
    np.testing.assert_allclose(th.cum[:, -1].numpy(), 1.0)
    np.testing.assert_allclose(th.mean.numpy(), np.asarray(jh.mean),
                               atol=STD_RTOL * max(jstd))


def test_noise_histogram_fit_matches_jax():
    """``fit`` keeps the reference's numpy body: same edges, cumulative
    probabilities and moments (degenerate and non-finite samples too)."""
    from repro.core.dnf import NoiseHistogram as JHist
    from repro.core.dnf import select_layers_by_std as j_select

    rng = np.random.default_rng(0)
    samples = [rng.normal(size=(3, 50)).astype(np.float32) * s
               for s in (0.1, 2.0, 0.5)]
    samples[1][0, 0] = np.inf
    samples.append(np.full((4,), 3.0, np.float32))
    th = [NoiseHistogram.fit(s, num_bins=20) for s in samples]
    jh = [JHist.fit(s, num_bins=20) for s in samples]
    for t, j in zip(th, jh):
        for f in ("edges", "cum", "mean", "std"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    st = NoiseHistogram.stack(th)
    assert st.edges.shape == (4, 21)
    assert torch.equal(st.layer(2).cum, th[2].cum)
    assert select_layers_by_std(th, 0.5) == j_select(jh, 0.5)
