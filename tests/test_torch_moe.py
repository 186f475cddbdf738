"""The port's Mixture-of-Experts decoder (``models/moe.py``, the MoE layer
of ``models/lm.py``, per-expert packing, the converter) against the JAX
package's, on the CPU.

Weights are the JAX package's (``init_params`` on the granite-moe-1b-a400m
smoke config: f32, 2 layers, d_model 128, 8 experts, top-2, SwiGLU 256),
carried across by ``models.convert.from_jax_params``; inputs are numpy
draws from a seed.  JAX's Pallas kernels run in interpret mode.  Bars:

  * routing (``_route``): expert ids equal to JAX's, gates and aux within
    ``ROUTE_TOL`` (XLA's ``exp`` and the mean's sum order differ from
    PyTorch's in the last f32 bit); a tied router picks JAX's experts
    (the lower index first);
  * packing: each expert's codes, scales and gains bit-equal to the
    ``[ex]`` slice of JAX's pack of the stacked (E, K, N) leaf;
  * the float block (the masked f32 loop against JAX's sort +
    ``ragged_dot`` + scatter-add) within ``FLOAT_TOL``, SwiGLU and GeGLU;
  * the ABFP block (``abfp_packed`` / ``abfp_fused``, tile 32, gain 8,
    noise 0.5) on noise-key seeds 0..3: each of the 24 dense calls' bf16
    outputs against JAX's, the flipped elements and the rows (tokens)
    they fall in counted and printed.  Flips come from the interpret-mode
    kernel's one-ULP flips and, on wo, from activation codes that a
    last-bit difference of SiLU moves (a moved code flips most of its
    row).  Measured over both layers, 4 inputs and seeds 0..3: at most 4
    of a call's 16 rows differ, 12-98 of the 24 calls' 73,728 outputs,
    and the block's output within 0.022 of JAX's.  Bars: at most
    ``ABFP_CALL_ROWS`` rows of any call (a wrong noise seed or call order
    moves all 16), the output within ``ABFP_TOL``;
  * float: a prefill pass and decode ticks (within ``FLOAT_TOL``, greedy
    tokens equal), chunked prefill equal to token-by-token decode in the
    port (within ``FLOAT_TOL``),
    the teacher-forced ``forward``'s logits and aux, and one float train
    step's ``loss`` and ``aux_loss``, against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_state
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.models import prefill as j_prefill
from repro.models.layers import Numerics as JNumerics
from repro.models.packing import pack_model_params as j_pack
from repro.models.packing import packed_param_bytes as j_packed_bytes
from repro.optim import optimizers as jopt
from repro.training.train_lib import TrainConfig as JTrainConfig
from repro.training.train_lib import make_train_step as j_make_train_step
from repro_torch import optim
from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import PackedWeight, QuantConfig
from repro_torch.models import (
    Numerics,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    pack_model_params,
    packed_param_bytes,
    prefill,
)
from repro_torch.models import moe
from repro_torch.models.convert import from_jax_params
from repro_torch.models.lm import calls_per_layer
from repro_torch.serving.runners import state_tensors
from repro_torch.training import TrainConfig, make_train_step

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "granite-moe-1b-a400m"
ROUTE_TOL = 1e-6
FLOAT_TOL = 1e-5
ABFP_TOL = 5e-2
ABFP_CALL_ROWS = 6
KEY_SEED = 3
ABFP = dict(tile_width=32, gain=8.0, noise_lsb=0.5)
T = 16


@pytest.fixture(scope="module")
def model():
    """JAX's params (numpy leaves) and the port's copy."""
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jm))
    return jm, tm, jp, from_jax_params(jp, tm, device="cpu")


def _quant(mode):
    kw = {} if mode == "float" else ABFP
    return JQuantConfig(mode=mode, **kw), QuantConfig(mode=mode, **kw)


def _keys(seed=KEY_SEED, t=0):
    k = prng.fold_in(prng.PRNGKey(seed), t)
    return jnp.asarray(k, jnp.uint32), k


def _layer_moe(jp, tp, li):
    return (jax.tree.map(lambda a: a[li], jp["groups"][0]["moe"]),
            tp["layers"][li]["moe"])


def _x(seed, d, rows=T):
    return np.random.default_rng(seed).normal(size=(rows, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("li", [0, 1])
def test_route_matches_jax(model, li):
    jm, tm, jp, tp = model
    jl, tl = _layer_moe(jp, tp, li)
    x = _x(li, tm.d_model, 64)
    jg, je, ja = j_moe._route(jnp.asarray(x), jl["router"], jm)
    tg, te, ta = moe._route(torch.from_numpy(x), tl["router"], tm)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=ROUTE_TOL)


def test_route_ties_pick_the_lower_expert_like_jax(model):
    """A zero router ties every expert (top-2 = experts 0 and 1); a router
    whose columns 5 and 6 copy columns 2 and 1 ties those pairs, and where
    a pair straddles the k-th place the lower index wins."""
    jm, tm, jp, tp = model
    x = _x(5, tm.d_model, 64)
    w = np.asarray(jp["groups"][0]["moe"]["router"][0]).copy()
    w[:, 5], w[:, 6] = w[:, 2], w[:, 1]
    for router in (np.zeros_like(w), w):
        _, je, _ = j_moe._route(jnp.asarray(x), jnp.asarray(router), jm)
        _, te, _ = moe._route(torch.from_numpy(x), torch.from_numpy(router),
                              tm)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # A tied copy is chosen only beside its lower-index twin.
    chosen = te.numpy()
    for hi, lo in ((5, 2), (6, 1)):
        rows = (chosen == hi).any(-1)
        assert rows.any() and (chosen[rows] == lo).any(-1).all()
    _, te, _ = moe._route(torch.from_numpy(x), torch.zeros(tm.d_model, 8), tm)
    assert (te.numpy() == [0, 1]).all()


# ---------------------------------------------------------------------------
# Packing, converter, seed table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packed(model):
    """Each ABFP mode's packs of the MoE blocks: JAX's of the stacked
    (layers, E, K, N) leaves, the port's layer by layer."""
    jm, tm, jp, tp = model
    out = {}
    for mode in ("abfp_packed", "abfp_fused"):
        jq, tq = _quant(mode)
        # Jitted: one compile in place of an eager compile per op.
        out[mode] = (jax.jit(lambda t, q=jq: j_pack(t, q))(
                         jp["groups"][0]["moe"]),
                     [pack_model_params(layer["moe"], tq)
                      for layer in tp["layers"]])
    return out


@pytest.mark.parametrize("mode", ["abfp_packed", "abfp_fused"])
def test_experts_pack_like_jax(model, packed, mode):
    jm, tm, jp, tp = model
    jpk, tpk = packed[mode]
    for li, layer in enumerate(tpk):
        assert isinstance(layer["router"], torch.Tensor)
        for name in ("wi", "wg", "wo"):
            assert len(layer[name]) == tm.num_experts
            for ex, pw in enumerate(layer[name]):
                want = jpk[name][li][ex]
                assert isinstance(pw, PackedWeight)
                for f in ("codes", "scales") + (
                        ("gains",) if mode == "abfp_fused" else ()):
                    w = np.asarray(getattr(want, f)).astype(np.float32)
                    assert torch.equal(getattr(pw, f).float(),
                                       torch.from_numpy(w)), \
                        (li, name, ex, f)
                if mode == "abfp_packed":
                    assert pw.gains is None
    assert packed_param_bytes(tpk) == j_packed_bytes(jpk)


def test_converter_unstacks_the_experts(model):
    jm, tm, jp, tp = model
    for li, layer in enumerate(tp["layers"]):
        assert "mlp" not in layer and set(layer["moe"]) == {
            "router", "wi", "wg", "wo"}
        for name, t in layer["moe"].items():
            want = jp["groups"][0]["moe"][name][li]
            assert tuple(t.shape) == want.shape
            np.testing.assert_array_equal(t.numpy(), want)
    assert tuple(tp["layers"][0]["moe"]["wo"].shape) == (
        tm.num_experts, tm.d_ff, tm.d_model)
    assert calls_per_layer(tm) == 4 + 3 * tm.num_experts


def test_init_params_leaves_like_jax(model):
    """The port's own init: JAX's leaves, shapes, dtypes and standard
    deviations (not its values)."""
    jm, tm, jp, _ = model
    full = dataclasses.replace(tm, d_model=256, d_ff=128)
    got = init_params(0, full, device="cpu")["layers"][0]["moe"]
    assert got["router"].dtype == torch.float32
    for name, shape, std in (("router", (256, 8), 256 ** -0.5),
                             ("wi", (8, 256, 128), 256 ** -0.5),
                             ("wg", (8, 256, 128), 256 ** -0.5),
                             ("wo", (8, 128, 256), 128 ** -0.5)):
        assert tuple(got[name].shape) == shape
        assert abs(float(got[name].std()) / std - 1) < 0.05, name


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
def test_float_block_matches_ragged_moe(model, mlp_type):
    jm, tm, jp, tp = model
    jm = dataclasses.replace(jm, mlp_type=mlp_type)
    tm = dataclasses.replace(tm, mlp_type=mlp_type)
    jl, tl = _layer_moe(jp, tp, 0)
    x = _x(1, tm.d_model).reshape(2, T // 2, tm.d_model)
    jq, tq = _quant("float")
    jy, ja = j_moe.moe_block(jl, jnp.asarray(x), jm, JNumerics(jq))
    ty, ta = moe.moe_block(tl, torch.from_numpy(x), tm, Numerics(tq))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=ROUTE_TOL)


class _JRecorder(JNumerics):
    """JAX's Numerics, keeping every dense call's output."""

    def __init__(self, quant, key, rec):
        super().__init__(quant, key)
        self.rec = rec

    def dense(self, x, w):
        y = super().dense(x, w)
        self.rec.append(y)
        return y


class _TRecorder(Numerics):
    """The port's Numerics, keeping every dense call's output."""

    rec: list

    def dense(self, x, w):
        y = super().dense(x, w)
        self.rec.append(y)
        return y


@pytest.mark.parametrize("mode", ["abfp_packed", "abfp_fused"])
def test_abfp_block_matches_jax(model, packed, mode):
    jm, tm, _, _ = model
    jq, tq = _quant(mode)
    jpk, tpk = packed[mode]
    jl, tl = jax.tree.map(lambda a: a[0], jpk), tpk[0]
    x = _x(2, tm.d_model).reshape(2, T // 2, tm.d_model)

    def jfn(p, x, k):
        rec = []
        y, aux = j_moe.moe_block(p, x, jm, _JRecorder(jq, k, rec))
        return y, rec

    jfn = jax.jit(jfn)
    for seed in range(4):
        jk, tk = _keys(seed)
        jy, jrec = jfn(jl, jnp.asarray(x), jk)
        nx = _TRecorder(tq, tk)
        nx.rec = []
        ty, _ = moe.moe_block(tl, torch.from_numpy(x), tm, nx)
        assert len(nx.rec) == len(jrec) == 3 * tm.num_experts
        flips, rows = 0, np.zeros(T, bool)
        for got, want in zip(nx.rec, jrec):
            diff = got.float().numpy() != np.asarray(want, np.float32)
            assert diff.any(axis=-1).sum() <= ABFP_CALL_ROWS, seed
            flips += int(diff.sum())
            rows |= diff.any(axis=-1)
        err = float(np.abs(ty.numpy() - np.asarray(jy)).max())
        print(f"{mode} seed {seed}: {flips} outputs of the {len(jrec)} "
              f"calls flip, in {int(rows.sum())}/{T} rows; block output "
              f"max-abs difference {err:.3g}")
        assert err < ABFP_TOL


def test_more_than_64_experts_raise():
    mcfg = dataclasses.replace(smoke_config(ARCH), d_model=8, d_ff=8,
                               num_experts=65)
    params = moe.init_moe(torch.Generator().manual_seed(0), mcfg, "cpu")
    x = torch.zeros(1, 2, 8)
    for mode in ("abfp_packed", "abfp_fused"):
        with pytest.raises(ValueError, match="64 experts"):
            moe.moe_block(params, x, mcfg, Numerics(QuantConfig(
                mode=mode, tile_width=8)))
    y, _ = moe.moe_block(params, x, mcfg, Numerics(QuantConfig(mode="float")))
    assert y.shape == x.shape


# ---------------------------------------------------------------------------
# The model passes
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax(model):
    """Float: a prefill pass of 2 x 12 tokens (7 real in row 1), then 4
    greedy decode ticks.  (The ABFP passes are held to JAX's through the
    block above and the engine's streams, ``tests/test_torch_moe_serving
    .py``: a JAX pass in interpret mode compiles for about 10 s.)"""
    jm, tm, jp, tp = model
    jq, tq = _quant("float")
    rng = np.random.default_rng(3)
    toks = rng.integers(1, tm.vocab_size, size=(2, 12)).astype(np.int32)
    n = np.array([12, 7], np.int32)
    jl, js = jax.jit(lambda p, s, a, b: j_prefill(p, s, a, b, jm))(
        jp, j_init_state(jm, 2, max_len=24), jnp.asarray(toks),
        jnp.asarray(n))
    tl, ts = prefill(tp, init_decode_state(tm, 2, 24, device="cpu"),
                     torch.from_numpy(toks), torch.from_numpy(n), tm,
                     Numerics(tq))
    step = jax.jit(lambda p, s, t: j_decode_step(p, s, t, jm))
    for t in range(5):
        jl, tl = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(tl, jl, rtol=FLOAT_TOL, atol=FLOAT_TOL)
        tok = jl.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1), tok)
        if t == 4:
            break
        jl, js = step(jp, js, jnp.asarray(tok))
        tl, ts = decode_step(tp, ts, torch.from_numpy(tok), tm)
    assert ts["position"].tolist() == (n + 4).tolist()


def test_chunked_prefill_equals_token_by_token_decode(model):
    """In the port, in float: chunks of 5 and 7 (each padded by 2) give
    the logits and every state tensor of 12 decode ticks within
    ``FLOAT_TOL``, as for the dense decoder (``tests/test_torch_model.py``:
    the CPU's f32 matmuls of 2 and 18 rows need not round alike; measured
    2.5e-6)."""
    _, tm, _, tp = model
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, tm.vocab_size, (2, 12)).astype(np.int32))
    s1 = init_decode_state(tm, 2, 24, device="cpu")
    for t in range(12):
        l1, s1 = decode_step(tp, s1, toks[:, t], tm)
    s2 = init_decode_state(tm, 2, 24, device="cpu")
    pos = 0
    for c in (5, 7):
        tk = torch.zeros(2, c + 2, dtype=torch.int32)
        tk[:, :c] = toks[:, pos:pos + c]
        l2, s2 = prefill(tp, s2, tk, torch.full((2,), c), tm)
        pos += c
    torch.testing.assert_close(l2, l1, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    for a, b in zip(state_tensors(s1), state_tensors(s2)):
        torch.testing.assert_close(b, a, rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_forward_logits_and_aux_match_jax(model):
    jm, tm, jp, tp = model
    toks = np.random.default_rng(6).integers(
        1, tm.vocab_size, (2, 16)).astype(np.int32)
    jl, ja = j_forward(jp, jnp.asarray(toks), jm)
    tl, ta = forward(tp, torch.from_numpy(toks), tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=ROUTE_TOL)
    assert float(ta) > 0.0


def test_float_train_step_matches_jax(model):
    """One AdamW step: ``loss`` and ``aux_loss`` (the MoE layers'
    load-balance losses, weighted into the objective) within FLOAT_TOL."""
    jm, tm, jp, tp = model
    jq, tq = _quant("float")
    j_init, j_step = j_make_train_step(
        jm, jopt.AdamW(jopt.constant(1e-3)), JTrainConfig(quant=jq))
    t_init, t_step = make_train_step(
        tm, optim.AdamW(optim.constant(1e-3)), TrainConfig(quant=tq),
        device="cpu")
    toks = np.random.default_rng(7).integers(
        1, tm.vocab_size, (4, 17)).astype(np.int32)
    jk, tk = _keys(10)
    _, jmet = jax.jit(j_step)(j_init(jp), {"tokens": jnp.asarray(toks)}, jk)
    _, tmet = t_step(t_init(tp), {"tokens": toks}, tk)
    for name in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=FLOAT_TOL)
    assert float(tmet["aux_loss"]) > 0.0
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
