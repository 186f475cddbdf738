"""The column-shard inputs of kernels 1, 2 and 4 and the tensor-parallel
engine, on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_tp.py

Bar: every shard's launch at its global column-block offset equals the
same columns of the one-device launch and its plain version with the
offset bit for bit (0 flips), on every route of the ABFP core; a virtual
mesh's engine serves the one-device engine's streams with CUDA graphs.
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
