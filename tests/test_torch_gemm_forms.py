"""K18's two forms as far as the CPU reaches them: the bf16 tensor-core
form's operand padding (``gemm.tc_operands``) and the tile choice of
both forms (``gemm.tc_tile``, ``gemm.simt_tile``).

TMA needs K % 8 == 0, 16-byte aligned x and y and y's rows a multiple of
8 long, so the wrapper zero-pads copies of other operands before the
launch; the kernel then writes the first N columns.  Padding with zeros
adds only zero products, so the padded product, sliced, equals the plain
version bit for bit on the CPU, and it is held to the reference's Pallas
kernel (interpret mode) on the same bf16 inputs within the bf16 rtol of
2e-2 (the answers round once to 2^-8 of their size in both packages).
The kernels themselves run on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gemm import gemm_pallas  # noqa: E402

from conftest import assert_close  # noqa: E402

tgemm = importlib.import_module("repro_torch.kernels.gemm")

BF16_RTOL = 2e-2
# (M, K, N): K or N not a multiple of 8, and aligned ones
RAGGED = [(129, 257, 65), (1, 1, 1), (100, 13, 50), (64, 64, 60)]


def _bf16(rng, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_padded_product_equals_plain_bit_for_bit(m, k, n):
    """The operands the tensor-core form gets: K and y's row length
    rounded up to 8 with zeros, the answer in the first N columns, equal
    bit for bit to the plain version on the unpadded operands."""
    rng = np.random.default_rng(m + k + n)
    x, y = _bf16(rng, m, k), _bf16(rng, k, n)
    xp, yp = tgemm.tc_operands(x, y)
    kp = max(8, -(-k // 8) * 8)
    assert xp.shape == (m, kp) and yp.shape == (kp, max(8, -(-n // 8) * 8))
    assert xp.is_contiguous() and yp.is_contiguous()
    assert xp.data_ptr() % 16 == 0 and yp.data_ptr() % 16 == 0
    assert torch.equal(xp[:, :k], x) and not xp[:, k:].any()
    assert torch.equal(yp[:k, :n], y) and not yp[k:].any() \
        and not yp[:, n:].any()
    got = tgemm.gemm_plain(xp, yp)[:, :n]
    assert torch.equal(got, tgemm.gemm_plain(x, y))


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_padded_product_matches_pallas(m, k, n):
    """The padded route against the reference's Pallas kernel on the same
    bf16 inputs (padded to its 8-multiple blocks, interpret mode)."""
    rng = np.random.default_rng(m + k + n)
    x, y = _bf16(rng, m, k), _bf16(rng, k, n)
    got = tgemm.gemm_plain(*tgemm.tc_operands(x, y))[:, :n]
    mp, kp, np_ = (max(8, -(-v // 8) * 8) for v in (m, k, n))
    jx = jnp.zeros((mp, kp), jnp.bfloat16).at[:m, :k].set(
        jnp.asarray(x.float().numpy(), jnp.bfloat16))
    jy = jnp.zeros((kp, np_), jnp.bfloat16).at[:k, :n].set(
        jnp.asarray(y.float().numpy(), jnp.bfloat16))
    want = gemm_pallas(jx, jy, bm=mp, bn=np_, bk=kp, interpret=True)
    assert_close(got.float().numpy(),
                 np.asarray(jnp.asarray(want, jnp.float32))[:m, :n],
                 rtol=BF16_RTOL, name=f"padded gemm {m}x{k}x{n}")


def test_aligned_operands_are_not_copied():
    """K % 8 == 0, N % 8 == 0 and aligned pointers: the operands go to the
    kernel as they are; a view whose pointer is not 16-byte aligned is
    copied (TMA's base rule), though its shape needs no padding."""
    rng = np.random.default_rng(0)
    x, y = _bf16(rng, 24, 16), _bf16(rng, 16, 40)
    xp, yp = tgemm.tc_operands(x, y)
    assert xp is x and yp is y
    wide = _bf16(rng, 25, 16)
    view = wide[1:]                      # 32 bytes on: aligned
    assert tgemm.tc_operands(view, y)[0] is view
    odd = _bf16(rng, 1, 16 * 24 + 1)[0, 1:].view(24, 16)   # 2 bytes on
    xo, yo = tgemm.tc_operands(odd, y)
    assert xo is not odd and xo.data_ptr() % 16 == 0 and yo is y
    assert torch.equal(xo, odd)


@pytest.mark.parametrize("m,n,tile", [
    (4096, 4096, 128), (1536, 1536, 128), (1000, 700, 64), (64, 64, 64),
    (128, 128, 64), (1408, 1408, 64), (1, 4096, 64), (4096, 64, 64)])
def test_simt_tile_fills_the_card(m, n, tile):
    """128 x 128 where those tiles give at least one CTA an SM (132 on an
    H100 SXM: 12 x 12 = 144 at 1536^2), else 64 x 64 (11 x 11 = 121 at
    1408^2; ops.gemm's 1000 x 700; the registry's squares)."""
    assert tgemm.simt_tile(m, n) == tile
    assert tgemm.simt_tile(m, n, sms=1) == 128


@pytest.mark.parametrize("m,n,tile", [
    (4096, 4096, 256), (4096, 64 * 64 + 1, 256), (1000, 700, 128),
    (2048, 2048, 128), (2176, 2048, 256), (1, 1, 128), (129, 65, 128)])
def test_tc_tile_fills_the_card(m, n, tile):
    """The bf16 form's 128 x 256 tiles where they give at least one CTA an
    SM (17 x 8 = 136 at 2176 x 2048), else 128 x 128 (16 x 8 = 128 at
    2048^2; 8 x 3 = 24 at ops.gemm's 1000 x 700)."""
    assert tgemm.tc_tile(m, n) == tile
    assert tgemm.tc_tile(m, n, sms=1) == 256


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor in bf16 or float32 takes the plain version, at a
    ragged shape too: no padding, no library."""
    rng = np.random.default_rng(3)
    x, y = _bf16(rng, 100, 13), _bf16(rng, 13, 50)
    got = tgemm.gemm_fused(x, y)
    assert got.dtype == torch.bfloat16 and got.shape == (100, 50)
    assert torch.equal(got, tgemm.gemm_plain(x, y))
    assert torch.equal(tgemm.gemm_fused(x.float(), y.float()),
                       tgemm.gemm_plain(x.float(), y.float()))
