"""The cacheless forward of the recurrent and hybrid families against the
JAX package's, on the CPU.

Weights are the JAX package's (``init_params``) on the recurrentgemma-2b
smoke config cut to 5 layers (``dataclasses.replace``: the pattern (R, R,
A) then leaves a remainder, ``extra/0`` and ``extra/1``) and the
xlstm-350m smoke config (2 layers), f32, d_model 128, carried across by
``from_jax_params``.  Sequences are S = 96 tokens, past the smoke window
of 64.  Inputs are made with numpy from a seed; both sides take the same
noise keys (the port's threefry chain).  JAX's Pallas kernels run in
interpret mode.  Bars:

  * ``associative_scan`` (RG-LRU's linear recurrence) against
    ``jax.lax.associative_scan`` with the same operator: rtol = atol =
    ``SCAN_TOL``.  Both associate alike; XLA on the CPU may contract
    ``a2 * b1 + b2`` into one FMA, which PyTorch's two ops round twice;
  * the three blocks without a state (RG-LRU's scan, the chunkwise mLSTM
    at chunks 4 and 128, the sLSTM fold) over S = 130 (a multiple of
    neither chunk), and RG-LRU from a given state (``h0`` folded into
    position 0): ``float`` outputs and states within rtol = atol =
    ``FLOAT_TOL`` (``MLSTM_FLOAT_TOL`` at chunk 128); ``abfp_kernel``
    (tile 32, gain 8, noise 0.5, a pinned key): the rows (tokens) whose
    bf16-rounded outputs differ from JAX's at most ``ABFP_ROW_SHARE`` of
    all, max-abs ``ABFP_BLOCK_TOL``, states within 2e-2;
  * ``forward`` on both families, flash attention on and off: ``float``
    logits within rtol = atol = ``FLOAT_TOL`` (xlstm ``MLSTM_FLOAT_TOL``);
    ``abfp_kernel`` logits max-abs below ``ABFP_PASS_TOL``
    (``tests/test_torch_eval.py``'s bar), and the rows of hidden states
    that differ counted (a difference at token t reaches every later token
    through the recurrent state, so the count is reported, not held);
  * the port's ``forward`` against its own decode ticks token by token:
    rtol = atol = 2e-2 (hybrid) and 3e-2 (xlstm), the JAX package's
    ``test_decode_matches_forward_hybrid`` / ``_ssm`` bars;
  * ``evaluate_abfp`` (float accuracy equal; ABFP within ``ACC_TOL``) and
    ``capture_histograms`` (one std per layer of every kind, within
    ``STD_RTOL``);
  * kernel 5's plain version at head dim 256 (causal, windowed) against
    the Pallas kernel: rtol = atol = 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import list_archs as j_list_archs
from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models.lm import lm_head_logits as j_lm_head_logits
from repro.models import recurrent as j_rec
from repro.models.layers import Numerics as JNumerics
from repro.training.finetune import capture_histograms as j_capture
from repro.training.finetune import evaluate_abfp as j_evaluate
from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import (
    Numerics,
    decode_step,
    forward,
    init_decode_state,
    lm_head_logits,
    recurrent,
)
from repro_torch.models.convert import from_jax_params
from repro_torch.models.lm import check_supported
from repro_torch.training import capture_histograms, evaluate_abfp

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

SCAN_TOL = 1e-6
FLOAT_TOL = 1e-5
# The chunkwise mLSTM at chunk 96-128 sums 96-128-term f32 dot products in
# another order than XLA (measured 4.3e-5 on a block at chunk 128, 2.0e-5
# on xlstm's logits).
MLSTM_FLOAT_TOL = 1e-4
# abfp_kernel blocks: the share of rows (tokens) with an element apart from
# JAX's in bf16, and the max-abs difference (measured over 260 rows: RG-LRU
# 6-7 rows by one ULP each; mLSTM 16-17 rows and sLSTM 14, whole rows where
# an f32 last-bit difference moved an activation code of the block's output
# projection; max-abs 0.0377).  A wrong seed or call order moves every row.
ABFP_ROW_SHARE = 0.1
ABFP_BLOCK_TOL = 0.1
ABFP_PASS_TOL = 0.5
STD_RTOL = 1e-2
B, S = 2, 96
# evaluate_abfp: batches of B x (EVAL_S + 1) tokens (past the window).
EVAL_S = S
ACC_TOL = 2 / (B * EVAL_S)
ABFP = dict(tile_width=32, gain=8.0, noise_lsb=0.5)
LAYERS = {"recurrentgemma-2b": 5, "xlstm-350m": 2}
# block -> (arch, layer index, params key)
BLOCKS = {"rglru": ("recurrentgemma-2b", 0, "rglru"),
          "mlstm": ("xlstm-350m", 0, "mlstm"),
          "slstm": ("xlstm-350m", 1, "slstm")}


def _configs(arch, **kw):
    kw = dict(num_layers=LAYERS[arch], **kw)
    return (dataclasses.replace(j_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX params and the port's copy."""
    out = {}
    for arch in LAYERS:
        jm, tm = _configs(arch)
        jp = j_init_params(jax.random.PRNGKey(0), jm)
        out[arch] = (jp, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                         device="cpu"))
    return out


def _quant(mode):
    kw = {} if mode == "float" else ABFP
    return JQuantConfig(mode=mode, **kw), QuantConfig(mode=mode, **kw)


def _keys(seed):
    k = prng.fold_in(prng.PRNGKey(seed), 0)
    return jnp.asarray(k, jnp.uint32), k


def _tokens(seed, b=B, s=S):
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(
        np.int32)


def _rows_apart(got: np.ndarray, want: np.ndarray, what: str) -> int:
    """The rows (tokens) of (..., d) outputs in which a bf16-rounded
    element differs from JAX's; printed with the element count and the
    max-abs difference."""
    g, w = (torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16) for a in (got, want))
    diff = (g != w).reshape(-1, g.shape[-1])
    n, rows = int(diff.sum()), int(diff.any(-1).sum())
    print(f"{what}: {n}/{diff.numel()} elements in {rows}/{diff.shape[0]} "
          f"rows differ, max-abs {float(np.abs(got - want).max()):.3g}")
    return rows


# ---------------------------------------------------------------------------
# The associative scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 7, 130])
def test_associative_scan_matches_jax(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (3, s, 40)).astype(np.float32)
    b = rng.normal(size=(3, s, 40)).astype(np.float32)

    def op(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return a1 * a2, a2 * b1 + b2

    _, want = jax.lax.associative_scan(op, (jnp.asarray(a), jnp.asarray(b)),
                                       axis=1)
    got = recurrent._linear_recurrence(torch.from_numpy(a),
                                       torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    # The recurrence itself, folded one step at a time in f64.
    h, seq = np.zeros((3, 40)), []
    for t in range(s):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The blocks without a decode state
# ---------------------------------------------------------------------------


BLOCK_CASES = [("rglru", None, False), ("rglru", None, True),
               ("mlstm", 4, False), ("mlstm", 128, False),
               ("slstm", None, False)]


@pytest.mark.parametrize("mode", ["float", "abfp_kernel"])
@pytest.mark.parametrize("block,chunk,h0", BLOCK_CASES)
def test_block_without_state_matches_jax(models, block, chunk, h0, mode):
    arch, li, key = BLOCKS[block]
    jm, tm = _configs(arch)
    jp, tp = models[arch]
    jq, tq = _quant(mode)
    glen = len(jm.block_pattern)
    jparams = jax.tree.map(lambda a: a[0], jp["groups"][li % glen][key])
    tparams = tp["layers"][li][key]
    rng = np.random.default_rng(list(BLOCKS).index(block) + 10 * h0)
    s = 130
    x = rng.normal(size=(B, s, jm.d_model)).astype(np.float32)
    kw = {} if chunk is None else {"chunk": chunk}
    jst = tst = None
    if h0:
        st = {"conv": rng.normal(size=(B, jm.conv_width - 1, jm.lru_width)),
              "h": rng.normal(size=(B, jm.lru_width))}
        st = {k: v.astype(np.float32) for k, v in st.items()}
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    j_block = {"rglru": j_rec.rglru_block, "mlstm": j_rec.mlstm_block,
               "slstm": j_rec.slstm_block}[block]
    t_block = {"rglru": recurrent.rglru_block, "mlstm": recurrent.mlstm_block,
               "slstm": recurrent.slstm_block}[block]
    jk, tk = _keys(4)
    jy, jnew = jax.jit(lambda p, x, st, k: j_block(
        p, x, jm, JNumerics(jq, k), state=st, **kw))(
        jparams, jnp.asarray(x), jst, jk)
    ty, tnew = t_block(tparams, torch.from_numpy(x), tm, Numerics(tq, tk),
                       state=tst, **kw)
    if h0:
        for k in st:                 # the given state is not written
            assert np.array_equal(tst[k].numpy(), st[k]), k
    jy = np.asarray(jy, np.float32)
    if mode == "float":
        tol = MLSTM_FLOAT_TOL if chunk == 128 else FLOAT_TOL
        np.testing.assert_allclose(ty.numpy(), jy, rtol=tol, atol=tol)
    else:
        got = ty.float().numpy()
        rows = _rows_apart(got, jy, f"{block} {mode}")
        assert rows <= ABFP_ROW_SHARE * got.size // got.shape[-1]
        assert float(np.abs(got - jy).max()) <= ABFP_BLOCK_TOL
        tol = 2e-2
    assert set(tnew) == set(jnew)
    for k in jnew:
        np.testing.assert_allclose(tnew[k].float().numpy(),
                                   np.asarray(jnew[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


def test_parallel_forms_leave_autograd_a_clean_graph(models):
    """Every block's parallel form under autograd: a backward through it
    reaches every weight, and no in-place write trips a saved tensor."""
    for block, (arch, li, key) in BLOCKS.items():
        _, tm = _configs(arch)
        params = {k: v.detach().clone().requires_grad_(v.is_floating_point())
                  for k, v in models[arch][1]["layers"][li][key].items()}
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(2, 20, tm.d_model)).astype(np.float32)).requires_grad_()
        fn = {"rglru": recurrent.rglru_block, "mlstm": recurrent.mlstm_block,
              "slstm": recurrent.slstm_block}[block]
        y, _ = fn(params, x, tm, Numerics(QuantConfig(mode="float")),
                  **({"chunk": 8} if block == "mlstm" else {}))
        y.square().sum().backward()
        assert x.grad is not None and float(x.grad.abs().max()) > 0
        for k, p in params.items():
            if k != "skip_scale":    # zero-initialized; its gradient is not
                assert float(p.grad.abs().max()) > 0, (block, k)


# ---------------------------------------------------------------------------
# The forward, evaluation and DNF capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", list(LAYERS))
def test_float_forward_matches_jax(models, arch, flash):
    jm, tm = _configs(arch, use_flash_attention=flash)
    jp, tp = models[arch]
    toks = _tokens(1)
    jl, _ = j_forward(jp, jnp.asarray(toks), jm)
    tl, taux = forward(tp, torch.from_numpy(toks), tm)
    assert tl.shape == (B, S, tm.vocab_size) and float(taux) == 0.0
    tol = MLSTM_FLOAT_TOL if arch == "xlstm-350m" else FLOAT_TOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch,flash", [("recurrentgemma-2b", False),
                                        ("recurrentgemma-2b", True),
                                        ("xlstm-350m", False)])
def test_abfp_kernel_forward_matches_jax(models, arch, flash):
    jm, tm = _configs(arch, use_flash_attention=flash)
    jq, tq = _quant("abfp_kernel")
    jp, tp = models[arch]
    toks = _tokens(2)
    jk, tk = _keys(6)
    jh, _ = j_forward(jp, jnp.asarray(toks), jm, JNumerics(jq, jk),
                      return_hidden=True)
    th, _ = forward(tp, torch.from_numpy(toks), tm, Numerics(tq, tk),
                    return_hidden=True)
    _rows_apart(th.numpy(), np.asarray(jh), f"{arch} flash={flash} hidden")
    # The logits as ``forward`` computes them: the head under fold 999,983.
    jl = np.asarray(j_lm_head_logits(jp, jh, jm, JNumerics(jq, jk)))
    tl = lm_head_logits(tp, th, tm, Numerics(tq, tk)).numpy()
    d = np.abs(jl - tl)
    print(f"{arch} flash={flash}: logits max-abs {d.max():.3g}, argmax "
          f"equal {float((jl.argmax(-1) == tl.argmax(-1)).mean()):.3f}")
    assert d.max() < ABFP_PASS_TOL


@pytest.mark.parametrize("arch,tol", [("recurrentgemma-2b", 2e-2),
                                      ("xlstm-350m", 3e-2)])
def test_forward_matches_decode_ticks(models, arch, tol):
    """The port's parallel forms against its own token-by-token decode."""
    _, tm = _configs(arch)
    tp = models[arch][1]
    toks = torch.from_numpy(_tokens(3, s=72))
    fwd, _ = forward(tp, toks, tm)
    state = init_decode_state(tm, B, 16, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, state = decode_step(tp, state, toks[:, t], tm)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), fwd, rtol=tol, atol=tol)


def _greedy_batches(tp, tm, s, n_batches=2):
    """Row 0 of each batch continues a random token greedily under the
    float model (its accuracy 1), row 1 is random."""
    out = []
    for i in range(n_batches):
        toks = _tokens(20 + i, s=s + 1)
        st = init_decode_state(tm, B, 16, device="cpu")
        tok = torch.from_numpy(toks[:, 0])
        for t in range(s):
            logits, st = decode_step(tp, st, tok, tm)
            tok = logits.argmax(-1).to(torch.int32)
            toks[0, t + 1] = int(tok[0])
        out.append({"tokens": toks})
    return out


def test_evaluate_and_capture_match_jax(models):
    for arch in LAYERS:
        jm, tm = _configs(arch, use_flash_attention=True)
        jp, tp = models[arch]
        batches = _greedy_batches(tp, tm, EVAL_S, n_batches=1)
        jk, tk = _keys(5)
        for mode in ("float", "abfp_kernel"):
            jq, tq = _quant(mode)
            want = j_evaluate(jp, [{"tokens": jnp.asarray(b["tokens"])}
                                   for b in batches], jm, jq, key=jk)
            got = evaluate_abfp(tp, batches, tm, tq, key=tk)
            print(f"{arch} {mode} accuracy: port {got}, JAX {want}")
            if mode == "float":
                assert got == want and got >= 0.45
            else:
                assert abs(got - want) <= ACC_TOL
        jq, tq = _quant("abfp_kernel")
        toks = _tokens(7)
        jh, jstd = j_capture(jp, jnp.asarray(toks), jm, jq, key=jk)
        th, tstd = capture_histograms(tp, torch.from_numpy(toks), tm, tq,
                                      key=tk)
        print(f"{arch} per-layer dy std: port {tstd}, JAX {jstd}")
        assert len(tstd) == tm.num_layers and min(tstd) > 0
        np.testing.assert_allclose(tstd, jstd, rtol=STD_RTOL)
        assert th.edges.shape == tuple(jh.edges.shape)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96)])
def test_flash_ref_at_head_dim_256_matches_pallas(causal, window):
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((1, 200, 4, 256), (1, 200, 1, 256),
                             (1, 200, 1, 256)))
    want = np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, window=window, bq=128, bk=128))
    got = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window, bq=128, bk=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_check_supported_takes_every_family_off_the_serving_path():
    for name in j_list_archs():
        try:
            check_supported(smoke_config(name), serving=True)
        except NotImplementedError:
            continue                 # a family the port does not serve
        check_supported(smoke_config(name), serving=False)
