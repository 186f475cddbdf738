"""Why chatglm3-6b's narrow bf16 float prefill parts from JAX's: the two
CPU matmuls sum the contraction in different orders.

``tests/test_torch_dense_archs.py``'s narrow chatglm3-6b (2 layers,
d_model 256, 2 KV heads of 128, bf16) runs a float prefill pass of 2 x 16
tokens on both sides from JAX's weights and state, JAX's compiled with
XLA's excess precision off.  With 2 query heads per KV head the logits
are bit-equal; with 4, 8 and 16 they part by 0.015625 (one bf16 ULP of
logits between 2 and 4).  Op by op on equal inputs, every bf16 matmul
(and the f32 attention einsums) parts in a few elements by one ULP: XLA's
CPU dot and PyTorch's CPU GEMM each compute the f32 sum of the K products
correctly rounded to within f32 error, in different orders, so their f32
results differ in most elements past K = 256, and the bf16 rounding of
those sums lands on different sides of a rounding boundary in a few.
Computing the port's bf16 products in f32 and rounding once (XLA's bf16
dot does that) does not remove it.  No op of the port orders or rounds
against the reference's semantics; the gap grows with the elements per
pass (more heads: more projection and attention outputs that can flip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import init_decode_state as j_init_state
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.layers import Numerics as JNumerics
from repro_torch.configs import get_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.models import Numerics, prefill
from repro_torch.models.convert import from_jax_params, to_tensor

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

BF16_AS_WRITTEN = {"xla_allow_excess_precision": False}
ULP_LOGITS = 2.0 ** -6          # one bf16 ULP of a value in [2, 4)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("k", [512, 4096])
def test_cpu_matmuls_sum_in_other_orders(k):
    """f32: both within f32 rounding of the exact (f64) product, apart in
    most elements; bf16: apart by one ULP in a few elements, also when the
    port multiplies in f32 and rounds once."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, k)).astype(np.float32)
    w = (rng.normal(size=(k, 512)) * k ** -0.5).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    exact = (xt.double() @ wt.double()).numpy()
    j32 = np.asarray(jax.jit(lambda a, b: a.astype(jnp.float32)
                             @ b.astype(jnp.float32))(xb, wb))
    t32 = (xt.float() @ wt.float()).numpy()
    tol = 4 * k * np.finfo(np.float32).eps * (np.abs(xt.double().numpy())
                                              @ np.abs(wt.double().numpy()))
    assert (np.abs(j32 - exact) <= tol).all()
    assert (np.abs(t32 - exact) <= tol).all()
    assert (j32 != t32).mean() > 0.5
    jb = _bf16(jax.jit(lambda a, b: a @ b,
                       compiler_options=BF16_AS_WRITTEN)(xb, wb))
    for tb in ((xt @ wt).float().numpy(),
               (xt.float() @ wt.float()).bfloat16().float().numpy()):
        apart = jb != tb
        assert 0 < apart.sum() < 1e-3 * jb.size
        ulp = np.spacing(np.abs(jb[apart]).astype(np.float32)) * 2 ** 16
        assert (np.abs(jb - tb)[apart] <= ulp).all()


def test_chatglm_float_prefill_parts_by_one_ulp_past_two_heads_a_group():
    diffs = {}
    for h in (4, 8):
        kw = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=512,
                  num_heads=h, num_kv_heads=2, head_dim=128)
        jm = dataclasses.replace(j_get_config("chatglm3-6b"), **kw)
        tm = dataclasses.replace(get_config("chatglm3-6b"), **kw)
        jp = j_init_params(jax.random.PRNGKey(0), jm)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
        toks = np.random.default_rng(0).integers(1, 512, (2, 16)).astype(
            np.int32)
        n = np.array([16, 9], np.int32)
        js = j_init_state(jm, 2, max_len=32)
        jl, _ = jax.jit(lambda p, s, t, n: j_prefill(
            p, s, t, n, jm, JNumerics(JQuantConfig(mode="float"), None)),
            compiler_options=BF16_AS_WRITTEN)(jp, js, jnp.asarray(toks),
                                              jnp.asarray(n))
        kv = js["groups"][0]["kv"]
        state = {"layers": [{"kv": {k: to_tensor(np.asarray(a[i]), "cpu")
                                    for k, a in kv.items()}}
                            for i in range(kv["length"].shape[0])],
                 "position": to_tensor(np.asarray(js["position"]), "cpu")}
        tl, _ = prefill(tp, state, torch.from_numpy(toks),
                        torch.from_numpy(n), tm,
                        Numerics(QuantConfig(mode="float")))
        diffs[h] = float(np.abs(np.asarray(jl) - tl.numpy()).max())
    print(f"chatglm narrow float prefill, max |port - JAX| by query "
          f"heads: {diffs}")
    assert diffs[4] == 0.0
    assert 0.0 < diffs[8] <= ULP_LOGITS
