"""The column-shard inputs of kernels 1, 2 and 4 and the tensor-parallel
engine, on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_tp.py

Bar: every shard's launch at its global column-block offset equals the
same columns of the one-device launch and its plain version with the
offset bit for bit (0 flips), on every route of the ABFP core; a virtual
mesh's engine serves the one-device engine's streams with CUDA graphs,
and under a shard drop its graphs run equals its eager twin; the
expert-parallel MoE block on the card is the CPU's within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.abfp import QuantConfig, pack_abfp_weight
from repro_torch.kernels import ops
from repro_torch.kernels.abfp_decode_fused import (
    _fused_qkv_packed,
    concat_qkv,
    fused_qkv_packed_ref,
)
from repro_torch.kernels.abfp_matmul import (
    DECODE_ROWS,
    TWO_LAUNCH,
    _abfp_matmul,
    _abfp_matmul_packed,
    abfp_matmul_packed_ref,
    abfp_matmul_ref,
)
from repro_torch.kernels.ops import shard_columns
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

CFG = QuantConfig(mode="abfp_fused", tile_width=128, gain=8.0, noise_lsb=0.5)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _assert_bits_equal(got, want):
    n = int((got.cpu().view(torch.int16) != want.cpu().view(torch.int16))
            .sum())
    assert n == 0, f"{n}/{got.numel()} bf16 elements differ"


def _weight(rng, k, n):
    return torch.from_numpy((rng.laplace(size=(k, n)) * 0.08)
                            .astype(np.float32)).cuda()


def _x(rng, m, k):
    return torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                            ).cuda().to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [DECODE_ROWS, 16, 32, 64, TWO_LAUNCH])
@pytest.mark.parametrize("tp", [2, 4])
def test_cuda_packed_shards_equal_the_whole_launch(tp, rows):
    _need_cuda()
    rng = np.random.default_rng(tp + rows)
    m = 4 if rows in (DECODE_ROWS, TWO_LAUNCH) else 100
    pw = pack_abfp_weight(_weight(rng, 960, 1024), CFG, adaptive_gain=True)
    x = _x(rng, m, 960)
    seed = torch.tensor([321], dtype=torch.int32, device="cuda")
    whole = _abfp_matmul_packed(x, pw, CFG, seed, rows)
    sh = shard_columns(pw, tp)
    c = 1024 // tp
    for t, loc in enumerate(sh.shards):
        off, nj = sh.grid(t)
        got = _abfp_matmul_packed(x, loc, CFG, seed, rows, off, nj)
        _assert_bits_equal(got, whole[:, t * c:(t + 1) * c])
        _assert_bits_equal(got, abfp_matmul_packed_ref(
            x, loc, CFG, seed, col_block_offset=off, num_col_blocks=nj))
    assert not torch.equal(_abfp_matmul_packed(x, sh.shards[-1], CFG, seed,
                                               rows), got)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_cuda_fused_qkv_and_unpacked_shards_equal_the_whole_launch(tp):
    _need_cuda()
    rng = np.random.default_rng(10 + tp)
    pws = tuple(pack_abfp_weight(_weight(rng, 960, c), CFG,
                                 adaptive_gain=True) for c in (1024, 512, 512))
    x = _x(rng, 4, 960)
    seeds = torch.tensor([5, -6, 7], dtype=torch.int32, device="cuda")
    whole = _fused_qkv_packed(x, pws, CFG, seeds, concat_qkv(pws, CFG),
                              DECODE_ROWS)
    shs = [shard_columns(pw, tp) for pw in pws]
    for t in range(tp):
        loc = [s.shards[t] for s in shs]
        offs, njs = zip(*(s.grid(t) for s in shs))
        got = _fused_qkv_packed(x, loc, CFG, seeds, concat_qkv(loc, CFG),
                                DECODE_ROWS, offs, njs)
        want = fused_qkv_packed_ref(x, loc, CFG, seeds,
                                    col_block_offsets=offs,
                                    num_col_blocks=njs)
        for i, (g, w_) in enumerate(zip(got, want)):
            c = pws[i].n_cols // tp
            _assert_bits_equal(g, whole[i][:, t * c:(t + 1) * c])
            _assert_bits_equal(g, w_)
    kq = dataclasses.replace(CFG, mode="abfp_kernel")
    w = _weight(rng, 960, 1024).to(torch.bfloat16)
    xm = _x(rng, 256, 960)
    seed = seeds[:1]
    whole = _abfp_matmul(xm, w, kq, seed, None)
    sh = shard_columns(w, tp)
    c = 1024 // tp
    for t, loc in enumerate(sh.shards):
        off, nj = sh.grid(t)
        got = _abfp_matmul(xm, loc, kq, seed, None, off, nj)
        _assert_bits_equal(got, whole[:, t * c:(t + 1) * c])
        _assert_bits_equal(got, abfp_matmul_ref(
            xm, loc, kq, seed, col_block_offset=off, num_col_blocks=nj))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
def test_cuda_mesh_engine_serves_the_one_device_streams(shape):
    """tinyllama's smoke config in abfp_fused (tile 32, noise on) with
    CUDA graphs: the mesh engine's streams are the one-device engine's,
    and each decode tick launches kernel 1 once per column shard."""
    _need_cuda()
    mcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), kv_quant=True)
    params = init_params(0, mcfg, device="cuda")
    quant = QuantConfig(mode="abfp_fused", tile_width=32, gain=4.0,
                        noise_lsb=0.5)

    def serve(mesh):
        eng = ServingEngine(params, mcfg, capacity=4, max_len=32,
                            quant=quant, seed=0, prefill_chunks=(4, 8),
                            mesh=mesh)
        eng.warmup()
        ops.reset_launch_counts()
        done = eng.run([Request(uid=i, prompt=[3 + i, 5, 7 + i],
                                max_new_tokens=4) for i in range(4)])
        return {r.uid: r.generated for r in done}, ops.launch_counts()

    (one, n1), (got, n2) = serve(None), serve(make_host_mesh(*shape))
    assert got == one
    assert n2["abfp_matmul_packed"] > n1["abfp_matmul_packed"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4), (1, 2)], ids=["2x4", "1x2"])
def test_cuda_mesh_shard_drop_with_graphs_equals_eager(shape):
    """A shard drop on a mesh engine with CUDA graphs and on its eager
    twin (tinyllama's smoke config in abfp_fused, noise on): equal
    streams and counters, conservation, the mesh re-planned as the JAX
    engine plans it; at (2, 4) the model axis is kept and every graph
    captured before the drop is the one that replays after it, at (1, 2)
    it narrows to (1, 1) and the passes are captured again."""
    _need_cuda()
    from repro_torch.serving import FaultConfig, FaultPlan
    from repro_torch.serving.faults import FaultEvent

    mcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), kv_quant=True)
    params = init_params(0, mcfg, device="cuda")
    quant = QuantConfig(mode="abfp_fused", tile_width=32, gain=4.0,
                        noise_lsb=0.5)
    out = {}
    for graphs in (True, False):
        eng = ServingEngine(params, mcfg, capacity=4, max_len=64,
                            quant=quant, seed=0, prefill_chunks=(4, 8),
                            mesh=make_host_mesh(*shape), _graphs=graphs,
                            detect_every=2, faults=FaultPlan(
                                [FaultEvent(5, "shard_drop", "", shard=1)],
                                FaultConfig(rate=0.01)))
        eng.warmup()
        captured = {k: wp.graph for k, wp in eng._passes.items()}
        done = eng.run([Request(uid=i, prompt=list(range(1, 3 + 5 * i)),
                                max_new_tokens=6) for i in range(6)])
        out[graphs] = ({r.uid: r.generated for r in done},
                       dict(eng.metrics.faults))
        assert eng.metrics.conservation()["ok"] and len(done) == 6
        assert eng.metrics.faults["reshards"] == 1
        kept = tuple(eng.mesh.devices.shape) == (1, shape[1])
        assert tuple(eng.mesh.devices.shape) == ((1, 4) if shape == (2, 4)
                                                 else (1, 1))
        if graphs:
            assert all((eng._passes.get(k) is not None
                        and eng._passes[k].graph is g) == kept
                       for k, g in captured.items())
    assert out[True] == out[False]


@pytest.mark.cuda
def test_cuda_moe_block_sharded_equals_the_cpu_route():
    """The expert-parallel MoE block on the card and on the CPU, on the
    same f32 weights and input (granite's smoke config, capacity factors
    8.0 and 1.25, meshes (2, 4) and (1, 4)): y within 1e-5, aux within
    1e-6 relative (the card's f32 matmuls keep TF32 off)."""
    _need_cuda()
    from repro_torch.models import moe
    from repro_torch.models.layers import Numerics

    mcfg0 = smoke_config("granite-moe-1b-a400m")
    gen = torch.Generator().manual_seed(3)
    p = moe.init_moe(gen, mcfg0, "cpu")
    x = torch.randn(8, 16, mcfg0.d_model, generator=gen)
    nx = Numerics(QuantConfig(mode="float"))
    for cf in (8.0, 1.25):
        mcfg = dataclasses.replace(mcfg0, capacity_factor=cf)
        for shape in ((2, 4), (1, 4)):
            y0, a0 = moe.moe_block_sharded(p, x, mcfg, nx,
                                           make_host_mesh(*shape, "cpu"))
            y1, a1 = moe.moe_block_sharded(
                {k: v.cuda() for k, v in p.items()}, x.cuda(), mcfg, nx,
                make_host_mesh(*shape, "cuda"))
            torch.testing.assert_close(y1.cpu(), y0, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(a1.cpu(), a0, rtol=1e-6, atol=0)
