"""Column shards of kernels 1, 2 and 4 against the JAX Pallas kernels, and
the tensor-parallel dispatch (``kernels.ops.dense_tp``, ``dense_tp_row``,
``fused_qkv_dense``), on the CPU.

Each shard's plain version, at its global column-block offset in the
whole weight's grid, runs beside the Pallas kernel (interpret mode) on the
same local slice with ``col_block_offset`` and ``num_col_blocks``; the bar
is ``tests/test_torch_kernels.py``'s (bf16 equal except at most one
counted one-ULP flip in 1,000 elements).  The shards' outputs side by side
equal the port's one-device call bit for bit, and a shard without its
offset does not.  The dispatch cases are the unit cases of
``tests/test_sharded_serving.py``, on the port's virtual meshes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.abfp import PackedWeight as JPackedWeight
from repro.core.abfp import QuantConfig as JQuantConfig
from repro.core.abfp import pack_abfp_weight as j_pack
from repro.kernels.abfp_decode_fused import fused_qkv_packed_pallas
from repro.kernels.abfp_matmul import (
    abfp_matmul_packed_pallas,
    abfp_matmul_pallas,
)
from repro_torch.core import abfp as core_abfp
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig, pack_abfp_weight
from repro_torch.kernels import ops
from repro_torch.kernels.abfp_decode_fused import (
    concat_qkv,
    fused_qkv_packed,
    fused_qkv_packed_ref,
)
from repro_torch.kernels.abfp_matmul import (
    abfp_matmul,
    abfp_matmul_packed,
    abfp_matmul_packed_ref,
    abfp_matmul_ref,
    col_grid,
)
from repro_torch.kernels.ops import (
    dense,
    dense_tp,
    dense_tp_row,
    fused_qkv_dense,
    shard_columns,
    tp_shardable,
)
from repro_torch.launch.mesh import make_host_mesh
from test_torch_kernels import _cfgs, _weight, assert_bf16_match

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker


def _jlocal(jpw, a, e):
    """Columns a:e of a JAX pack as a pack of their own (gains whole)."""
    return JPackedWeight(jpw.codes[:, a:e], jpw.scales[:, a:e], jpw.k,
                         e - a, jpw.tile_width, jpw.bits_w, gains=jpw.gains)


# ---------------------------------------------------------------------------
# Kernel 1 (packed) and kernel 4 (unpacked), shard by shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gains", [False, True])
@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("tp", [2, 4])
def test_packed_shards_match_pallas_with_offsets(tp, m, gains):
    rng = np.random.default_rng(100 * tp + m + gains)
    jcfg, cfg = _cfgs(32, 0.5, 8.0 if gains else 1.0)
    k, n = 160, 512
    x = (rng.normal(size=(m, k)) * 0.7).astype(np.float32)
    w = _weight(rng, k, n)
    jpw = j_pack(jnp.asarray(w), jcfg, adaptive_gain=gains)
    pw = pack_abfp_weight(torch.from_numpy(w), cfg, adaptive_gain=gains)
    xt = torch.from_numpy(x)
    sh = shard_columns(pw, tp)
    c = n // tp
    outs = []
    for t, loc in enumerate(sh.shards):
        off, nj = sh.grid(t)
        assert (off, nj) == (t * c // 128, n // 128)
        want = abfp_matmul_packed_pallas(
            jnp.asarray(x), _jlocal(jpw, t * c, (t + 1) * c), jcfg,
            jnp.int32(4321), col_block_offset=jnp.int32(off),
            num_col_blocks=nj)
        got = abfp_matmul_packed(xt, loc, cfg, 4321, col_block_offset=off,
                                 num_col_blocks=nj)
        assert_bf16_match(got, want, f"kernel 1 tp={tp} shard {t} m={m} "
                                     f"gains={gains}")
        outs.append(got)
    whole = abfp_matmul_packed_ref(xt, pw, cfg, 4321)
    assert torch.equal(torch.cat(outs, -1), whole)
    # Without its offset the last shard draws another block's noise.
    assert not torch.equal(abfp_matmul_packed_ref(xt, sh.shards[-1], cfg,
                                                  4321), outs[-1])


@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("tp", [2, 4])
def test_unpacked_shards_match_pallas_with_offsets(tp, m):
    """Kernel 4 on a float column shard: its per-column weight scales make
    the shard's quantized weight the whole one's columns."""
    rng = np.random.default_rng(7 * tp + m)
    jcfg = JQuantConfig(mode="abfp_kernel", tile_width=32, gain=8.0,
                        noise_lsb=0.5)
    cfg = QuantConfig(mode="abfp_kernel", tile_width=32, gain=8.0,
                      noise_lsb=0.5)
    k, n = 96, 512
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = _weight(rng, k, n)
    wt = torch.from_numpy(w)
    sh = shard_columns(wt, tp)
    c = n // tp
    outs = []
    for t, loc in enumerate(sh.shards):
        off, nj = sh.grid(t)
        want = abfp_matmul_pallas(
            jnp.asarray(x), jnp.asarray(w[:, t * c:(t + 1) * c]), jcfg,
            jnp.int32(99), col_block_offset=jnp.int32(off),
            num_col_blocks=nj)
        got = abfp_matmul(torch.from_numpy(x), loc, cfg, 99,
                          col_block_offset=off, num_col_blocks=nj)
        assert_bf16_match(got, want, f"kernel 4 tp={tp} shard {t} m={m}")
        outs.append(got)
    whole = abfp_matmul_ref(torch.from_numpy(x), wt, cfg, 99)
    assert torch.equal(torch.cat(outs, -1), whole)


def test_column_grid_is_checked():
    assert col_grid(256) == (2, 0)
    assert col_grid(256, 2, 4) == (4, 2)
    for off, nj in ((3, 4), (-1, 4), (1, 2)):
        with pytest.raises(ValueError):
            col_grid(256, off, nj)


# ---------------------------------------------------------------------------
# Kernel 2 (fused QKV), shard by shard, and its dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gains", [False, True])
@pytest.mark.parametrize("tp,cols", [(2, (512, 256, 256)),
                                     (4, (512, 512, 1024))])
def test_fused_qkv_shards_match_pallas_with_offsets(tp, cols, gains):
    rng = np.random.default_rng(tp + gains)
    jcfg, cfg = _cfgs(32, 0.5, 8.0 if gains else 1.0)
    k, m = 128, 4
    x = rng.normal(size=(m, k)).astype(np.float32)
    ws = [_weight(rng, k, c) for c in cols]
    seeds = (11, -22, 33)
    jpws = [j_pack(jnp.asarray(w), jcfg, adaptive_gain=gains) for w in ws]
    pws = [pack_abfp_weight(torch.from_numpy(w), cfg, adaptive_gain=gains)
           for w in ws]
    shs = [shard_columns(pw, tp) for pw in pws]
    xt = torch.from_numpy(x)
    outs = ([], [], [])
    for t in range(tp):
        offs, njs = zip(*(s.grid(t) for s in shs))
        want = fused_qkv_packed_pallas(
            jnp.asarray(x),
            tuple(_jlocal(jp, t * c // tp, (t + 1) * c // tp)
                  for jp, c in zip(jpws, cols)),
            jcfg, tuple(jnp.int32(s) for s in seeds),
            col_block_offsets=tuple(jnp.int32(o) for o in offs),
            num_col_blocks=njs)
        got = fused_qkv_packed(xt, [s.shards[t] for s in shs], cfg, seeds,
                               col_block_offsets=offs, num_col_blocks=njs)
        for i, (g, wnt) in enumerate(zip(got, want)):
            assert_bf16_match(g, wnt, f"kernel 2 tp={tp} shard {t} "
                                      f"segment {i} gains={gains}")
            outs[i].append(g)
    whole = fused_qkv_packed_ref(xt, pws, cfg, seeds)
    for o, wh in zip(outs, whole):
        assert torch.equal(torch.cat(o, -1), wh)


def test_fused_qkv_dense_shards_all_three_at_tp2():
    """Three 256-column weights all shard at tp 2 (noise on: whole
    128-column blocks per shard): ``fused_qkv_dense`` takes the per-shard
    fused launch (with per-shard concatenations, as the placement builds
    them) and equals the one-device fused call and JAX's fused kernel."""
    rng = np.random.default_rng(5)
    jcfg, cfg = _cfgs(32, 0.5, 4.0)
    x = rng.normal(size=(4, 96)).astype(np.float32)
    ws = [_weight(rng, 96, 256) for _ in range(3)]
    pws = [pack_abfp_weight(torch.from_numpy(w), cfg, adaptive_gain=True)
           for w in ws]
    mesh = make_host_mesh(1, 2, "cpu")
    assert all(tp_shardable(pw, cfg, mesh) for pw in pws)
    xt = torch.from_numpy(x)
    seeds = torch.tensor([3, 1, 4], dtype=torch.int32)
    one = fused_qkv_dense(xt, pws, cfg, seeds)
    shs = [shard_columns(pw, 2) for pw in pws]
    qkv = tuple(concat_qkv([s.shards[t] for s in shs], cfg) for t in range(2))
    got = fused_qkv_dense(xt, shs, cfg, seeds, mesh, qkv=qkv)
    plain = fused_qkv_dense(xt, pws, cfg, seeds, mesh, plain=True)
    want = fused_qkv_packed_pallas(
        jnp.asarray(x),
        tuple(j_pack(jnp.asarray(w), jcfg, adaptive_gain=True) for w in ws),
        jcfg, tuple(jnp.int32(int(s)) for s in seeds))
    for i, (g, p, o, wnt) in enumerate(zip(got, plain, one, want)):
        assert torch.equal(g, o) and torch.equal(p, o)
        assert_bf16_match(g, wnt, f"fused_qkv_dense tp=2 segment {i}")


def test_fused_qkv_dense_falls_back_to_three_dense_tp_calls():
    """wk and wv of one 128-column block do not shard at tp 2 under noise:
    three ``dense_tp`` calls (wq sharded, wk and wv whole), equal to the
    one-device fused call."""
    rng = np.random.default_rng(6)
    _, cfg = _cfgs(32, 0.5, 4.0)
    x = torch.from_numpy(rng.normal(size=(4, 96)).astype(np.float32))
    pws = [pack_abfp_weight(torch.from_numpy(_weight(rng, 96, c)), cfg,
                            adaptive_gain=True) for c in (256, 64, 64)]
    mesh = make_host_mesh(2, 2, "cpu")
    assert [tp_shardable(pw, cfg, mesh) for pw in pws] == [True, False, False]
    seeds = (8, 9, 10)
    for g, o in zip(fused_qkv_dense(x, pws, cfg, seeds, mesh),
                    fused_qkv_dense(x, pws, cfg, seeds)):
        assert torch.equal(g, o)


# ---------------------------------------------------------------------------
# dense_tp / dense_tp_row: tests/test_sharded_serving.py's unit cases
# ---------------------------------------------------------------------------


def test_dense_tp_col_parallel_bit_identical():
    g = torch.Generator().manual_seed(0)
    mesh = make_host_mesh(2, 4, "cpu")
    x = torch.randn(8, 256, generator=g)
    w = torch.randn(256, 512, generator=g) * 0.1
    f = QuantConfig(mode="float")
    assert torch.equal(dense_tp(x, w, f, None, mesh), dense(x, w, f))
    # Packed with noise: tp 4 shards 512 padded columns as 128-lane blocks.
    cp = QuantConfig(mode="abfp_packed", tile_width=32, gain=8.0,
                     noise_lsb=0.5, out_dtype=torch.float32)
    pw = pack_abfp_weight(w, cp)
    assert torch.equal(dense_tp(x, pw, cp, 1234, mesh),
                       dense(x, pw, cp, 1234))
    # The same weight placed once (ColumnShards) runs the same.
    assert torch.equal(dense_tp(x, shard_columns(pw, 4), cp, 1234, mesh),
                       dense(x, pw, cp, 1234))
    ck = QuantConfig(mode="abfp_kernel", tile_width=32, gain=8.0,
                     noise_lsb=0.5, out_dtype=torch.float32)
    assert torch.equal(dense_tp(x, w, ck, 1234, mesh),
                       dense(x, w, ck, 1234))
    # A shard count that is not the mesh's is refused.
    with pytest.raises(ValueError):
        dense_tp(x, shard_columns(pw, 2), cp, 1234, mesh)


def test_dense_tp_counts_one_call_per_shard(monkeypatch):
    """On the CPU the wrappers run their plain versions: every shard is
    one wrapper call (on the card, one launch each)."""
    rng = np.random.default_rng(2)
    _, cfg = _cfgs(32, 0.5, 8.0)
    pw = pack_abfp_weight(torch.from_numpy(_weight(rng, 64, 512)), cfg,
                          adaptive_gain=True)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    calls = []
    real = ops.abfp_matmul_packed

    def spy(*a, **kw):
        calls.append(kw.get("col_block_offset"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "abfp_matmul_packed", spy)
    dense_tp(x, pw, cfg, 5, make_host_mesh(1, 4, "cpu"))
    assert calls == [0, 1, 2, 3]


def test_dense_tp_fallback_on_indivisible_columns():
    """Columns the mesh cannot split in whole lane blocks run replicated:
    the one-device call."""
    g = torch.Generator().manual_seed(1)
    mesh = make_host_mesh(1, 8, "cpu")
    cfg = QuantConfig(mode="abfp_packed", tile_width=32, gain=4.0,
                      noise_lsb=0.5, out_dtype=torch.float32)
    x = torch.randn(4, 96, generator=g)
    w = torch.randn(96, 130, generator=g) * 0.1     # Np = 256, tp = 8
    pw = pack_abfp_weight(w, cfg)
    assert not tp_shardable(pw, cfg, mesh)
    assert torch.equal(dense_tp(x, pw, cfg, 7, mesh), dense(x, pw, cfg, 7))
    # Without noise any even split shards (the shards pad to whole lanes).
    c0 = QuantConfig(mode="abfp_packed", tile_width=32, gain=4.0,
                     noise_lsb=0.0, out_dtype=torch.float32)
    pw0 = pack_abfp_weight(w, c0)
    assert tp_shardable(pw0, c0, mesh)
    assert torch.equal(dense_tp(x, pw0, c0, None, mesh), dense(x, pw0, c0))


def test_abfp_ref_never_shards():
    g = torch.Generator().manual_seed(3)
    mesh = make_host_mesh(1, 2, "cpu")
    cfg = QuantConfig(mode="abfp_ref", tile_width=32, gain=4.0,
                      noise_lsb=0.5)
    x = torch.randn(2, 64, generator=g)
    w = torch.randn(64, 512, generator=g) * 0.1
    assert not tp_shardable(w, cfg, mesh)
    key = prng.PRNGKey(4)
    assert torch.equal(dense_tp(x, w, cfg, key, mesh),
                       core_abfp.abfp_matmul(x, w, cfg, key))


def test_dense_tp_row_psum_matches_to_tolerance():
    g = torch.Generator().manual_seed(2)
    mesh = make_host_mesh(1, 8, "cpu")
    x = torch.randn(8, 256, generator=g)
    w = torch.randn(256, 64, generator=g) * 0.1
    cfg = QuantConfig(mode="float")
    y = dense_tp_row(x, w, cfg, mesh)
    torch.testing.assert_close(y, x @ w, rtol=1e-5, atol=1e-5)
    assert torch.equal(y, dense_tp_row(x, w, cfg, mesh))     # reproducible
    with pytest.raises(ValueError, match="float-only"):
        dense_tp_row(x, w, QuantConfig(mode="abfp_kernel"), mesh)
