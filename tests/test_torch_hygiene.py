"""The port stands alone and never runs on the CPU by accident.

In a fresh interpreter, importing every ``repro_torch`` module and
``chip_smoke`` (without running it) must load no ``jax``/``jaxlib``, no
module of the JAX package ``repro`` and no ``ml_dtypes``.  On a machine
without CUDA, the entry points called without ``device`` raise instead of
running on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.models import Numerics, init_decode_state, init_params
from repro_torch.serving import ServingEngine

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["bad"] == []
    for mod in ("repro_torch.kernels.abfp_matmul",
                "repro_torch.kernels.abfp_decode_fused",
                "repro_torch.kernels.flash_attention",
                "repro_torch.serving.engine", "repro_torch.launch.serve",
                "repro_torch.models.recurrent", "repro_torch.models.moe",
                "repro_torch.models.convert", "repro_torch.core.dnf",
                "repro_torch.training.finetune",
                "repro_torch.distributed.fault",
                "repro_torch.serving.stream", "repro_torch.serving.pages",
                "repro_torch.serving.faults",
                "repro_torch.core.tree", "repro_torch.core.energy",
                "repro_torch.kernels.ref", "repro_torch.optim.optimizers",
                "repro_torch.distributed.collectives",
                "repro_torch.training.train_lib",
                "repro_torch.data.synthetic",
                "repro_torch.checkpoint.checkpoint",
                "repro_torch.launch.train"):
        assert mod in doc["modules"]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")


def test_entry_points_without_device_raise_on_a_cpu_machine():
    _no_cuda()
    mcfg = smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(0, mcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_decode_state(mcfg, 2, 16)
    params = init_params(0, mcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, mcfg, capacity=1,
                      quant=QuantConfig(mode="float"))


def test_serve_cli_without_device_raises_on_a_cpu_machine():
    _no_cuda()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests",
         "1"], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_training_entry_points_without_device_raise_on_a_cpu_machine():
    _no_cuda()
    from repro_torch.optim import AdamW, constant
    from repro_torch.training import (
        TrainConfig,
        make_serve_steps,
        make_train_step,
    )
    from repro_torch.training.finetune import make_dnf_train_step

    mcfg = smoke_config("smollm-360m")
    opt = AdamW(constant(1e-3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(mcfg, opt, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serve_steps(mcfg)
    params = init_params(0, mcfg, device="cpu")
    from repro_torch.training import capture_histograms
    from repro_torch.core import prng
    hists, _ = capture_histograms(
        params, torch.ones((1, 8), dtype=torch.int64), mcfg,
        QuantConfig(mode="abfp_kernel", tile_width=32, noise_lsb=0.5),
        key=prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_dnf_train_step(mcfg, opt, hists)


def test_train_cli_without_device_raises_on_a_cpu_machine():
    _no_cuda()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "1"], capture_output=True, text=True, timeout=120,
        env=env)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


class _HostReads(TorchDispatchMode):
    """Counts the host data a pass body reads: every operator input with
    elements whose storage is none of the pass's own (the weights, the
    decode state, the pass buffers, or a tensor an earlier operator of the
    body made).  On the card each such input is a host-to-device copy,
    which a captured graph would replay with the words it held at
    capture.  A 0-dim host tensor is a constant that a kernel takes as a
    launch argument (or one that never leaves the host), not a copy."""

    def __init__(self, *trees):
        super().__init__()
        self.known = {t.untyped_storage().data_ptr()
                      for t in _tensors(trees)}
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            if (t.dim() and t.untyped_storage().data_ptr()
                    not in self.known):
                self.reads.append(str(func))
        out = func(*args, **kwargs)
        self.known.update(t.untyped_storage().data_ptr()
                          for t in _tensors(out))
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif hasattr(tree, "__dict__") and not isinstance(tree, type):
        tree = list(vars(tree).values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@pytest.mark.parametrize("shape", [("decode",), ("prefill", 16)])
def test_abfp_ref_pass_body_makes_no_host_to_device_copy(shape):
    """An ``abfp_ref`` pass reads each dense call's key from its key table
    in the pass buffers: the body reads no host data (the count stays 0),
    while a call handed a host key reads its words from the host."""
    mcfg = smoke_config("smollm-360m")
    params = init_params(0, mcfg, device="cpu")
    quant = QuantConfig(mode="abfp_ref", tile_width=32, noise_lsb=0.5)
    eng = ServingEngine(params, mcfg, capacity=2, max_len=32, device="cpu",
                        quant=quant, prefill_chunks=(16,))
    width = 1 if shape[0] == "decode" else shape[1]
    io, _ = eng._call(shape, prng.PRNGKey(3),
                      tokens=np.ones((2, width), np.int32),
                      n_tokens=np.array([width, 1]),
                      prev_mask=np.zeros(2, bool))
    wp = eng._passes[shape]
    with _HostReads(eng.params, eng.state, wp.io) as reads:
        wp.body(eng.state)
    assert reads.reads == []
    assert torch.isfinite(io.logits).all()
    with _HostReads(eng.params) as reads:
        Numerics(quant, prng.PRNGKey(3)).fold(0).dense(
            torch.ones(2, mcfg.d_model), params["layers"][0]["attn"]["wq"])
    assert reads.reads


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    _no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


# The kernels' A/B entries (a forced ABFP route) and the engine's private
# graph switch (``_graphs=False``: eager passes on the card): only their
# own module, the card tests and the smoke script may name them, so no
# model path and no CLI flag can reach them.
_AB_ENTRIES = ("_abfp_matmul(", "_abfp_matmul_packed(", "_fused_qkv_packed(",
               "_graphs")


def test_ab_entries_are_unreachable_from_the_model_paths():
    own = {("kernels", "abfp_matmul.py"): ("_abfp_matmul(",
                                           "_abfp_matmul_packed("),
           ("kernels", "abfp_decode_fused.py"): ("_fused_qkv_packed(",),
           ("serving", "engine.py"): ("_graphs",)}
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        allowed = own.get((path.parent.name, path.name), ())
        used = [e for e in _AB_ENTRIES if e in text and e not in allowed]
        assert not used, f"{path.relative_to(ROOT)} names {used}"
