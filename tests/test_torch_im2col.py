"""``repro_torch.models.im2col`` against the JAX package's ``im2col`` (the
paper's mapping of a convolution onto tiled matmuls, Sec. V), on the CPU:
the patches equal bit for bit, and a convolution computed as the patches
times the flattened kernel equals ``torch.nn.functional.conv2d``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import im2col as j_im2col
from repro_torch.models import im2col

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker


@pytest.mark.parametrize("b,h,w,c,kh,kw,stride", [
    (1, 5, 5, 1, 3, 3, 1), (2, 8, 7, 3, 3, 3, 1), (2, 9, 9, 4, 3, 3, 2),
    (1, 7, 10, 2, 1, 1, 1), (3, 6, 6, 5, 2, 3, 2), (1, 11, 11, 8, 7, 7, 4)])
def test_im2col_equals_jax(b, h, w, c, kh, kw, stride):
    x = np.random.default_rng(b * 100 + h + c).normal(
        size=(b, h, w, c)).astype(np.float32)
    got = im2col(torch.from_numpy(x), kh, kw, stride)
    want = np.asarray(j_im2col(jnp.asarray(x), kh, kw, stride))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # Patches @ the kernel flattened in (row, column, channel) order is the
    # convolution.
    oc = 3
    k = torch.from_numpy(np.random.default_rng(1).normal(
        size=(oc, c, kh, kw)).astype(np.float32))
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), k, stride=stride)
    mm = got @ k.permute(2, 3, 1, 0).reshape(kh * kw * c, oc)
    torch.testing.assert_close(mm, conv.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-5)
