"""The overlapped runtime on a virtual mesh, on the CPU: the analogue of
``tests/test_async.py``'s ``test_overlap_parity_mesh_2x4``.

The port's engine at mesh (2, 4), float and ``abfp_packed`` (tile 32,
gain 4, noise 0.5), serves the same prompts on the simulated-clock
blocking path and on the wall-clock overlapped path (sampling on the
device, dispatch ahead of delivery): the overlapped streams equal the
blocking mesh engine's bit for bit, and both equal the JAX package's
one-device engine's on the same weights at the pinned engine seed
(``tests/test_torch_mesh_serving.py``'s).
"""

import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ARCH = "tinyllama-1.1b"
SEED = 4
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6], [8, 1, 2, 3, 4, 5, 6, 7, 9], [13]]
FLOAT = QuantConfig(mode="float")
PACKED = QuantConfig(mode="abfp_packed", tile_width=32, gain=4.0,
                     noise_lsb=0.5)


@pytest.fixture(scope="module")
def pair():
    jm, tm = j_smoke_config(ARCH), smoke_config(ARCH)
    jp = j_init_params(jax.random.PRNGKey(0), jm)
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                       device="cpu")


def _outs(done):
    return {r.uid: tuple(int(t) for t in r.generated) for r in done}


def _jax_streams(jm, jp, quant):
    jq = (JQuantConfig(mode="float") if quant.mode == "float" else
          JQuantConfig(mode=quant.mode, tile_width=quant.tile_width,
                       gain=quant.gain, noise_lsb=quant.noise_lsb))
    eng = JServingEngine(jp, jm, capacity=4, max_len=64, quant=jq,
                         seed=SEED, prefill_chunks=(4, 8))
    return _outs(eng.run([JRequest(uid=i, prompt=list(p), max_new_tokens=4)
                          for i, p in enumerate(PROMPTS)]))


@pytest.mark.parametrize("quant", [FLOAT, PACKED],
                         ids=["float", "abfp_packed"])
def test_overlap_parity_mesh_2x4(pair, quant):
    jm, jp, tm, tp = pair
    kw = dict(capacity=4, max_len=64, quant=quant, seed=SEED,
              prefill_chunks=(4, 8), device="cpu",
              mesh=make_host_mesh(2, 4, "cpu"))

    def reqs():
        return [Request(uid=i, prompt=list(p), max_new_tokens=4)
                for i, p in enumerate(PROMPTS)]

    ref = _outs(ServingEngine(tp, tm, **kw).run(reqs()))
    ov = ServingEngine(tp, tm, clock=time.perf_counter, overlap=True, **kw)
    ov.warmup()
    got = _outs(ov.run(reqs()))
    ov.close()
    assert got == ref
    assert ov.metrics.conservation()["ok"]
    assert ref == _jax_streams(jm, jp, quant)
