"""The port's LM kernels (K18 GEMM, K20 flash attention), their ``ops``
and ``ref`` functions and registry specs against the JAX reference.

The same numpy inputs, made from a seed, go through the reference's
Pallas kernels (interpret mode on the CPU), its ``ops`` and oracles, and
through the port's wrappers on CPU tensors — which run the kernels'
plain PyTorch versions.  Tolerances: the registry specs' own (1e-4 for
the GEMM, whose float32 sums differ in order only; 1e-3 for attention,
whose online softmax rescales per kv tile), and 2e-2 for bfloat16, whose
answers round once to 2^-8 of their size in both packages.  The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.attention import flash_attention_pallas  # noqa: E402
from repro.kernels.gemm import gemm_pallas  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from conftest import assert_close  # noqa: E402

tgemm = importlib.import_module("repro_torch.kernels.gemm")
tattn = importlib.import_module("repro_torch.kernels.attention")

BF16_RTOL = 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------- K18 GEMM ----------------

@pytest.mark.parametrize("n", TK.get("gemm").sizes)
def test_gemm_plain_matches_pallas_and_oracle(n):
    """The registry's 4n x 4n squares: identical inputs from the two
    packages' case generators; the port's wrapper (the plain version)
    against the reference's Pallas kernel and both oracles."""
    tx, ty = TK.get("gemm").make_case(np.random.default_rng(n), n)
    jx, jy = RK.get("gemm").make_case(np.random.default_rng(n), n)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    got = tgemm.gemm_fused(tx, ty).numpy()
    assert_close(got, np.asarray(gemm_pallas(jx, jy, interpret=True)),
                 rtol=1e-4, name="plain vs pallas")
    assert_close(got, np.asarray(jref.gemm(jx, jy)), rtol=1e-4,
                 name="plain vs reference oracle")
    assert_close(tref.gemm(tx, ty).numpy(), np.asarray(jref.gemm(jx, jy)),
                 rtol=1e-4, name="oracles")
    spec = TK.get("gemm")
    assert_close(spec.run_kernel(tx, ty).numpy(),
                 spec.run_oracle(tx, ty).numpy(), rtol=spec.rtol,
                 name="spec faces")


@pytest.mark.parametrize("m,k,n", [(130, 70, 200), (1, 1, 1), (9, 300, 7),
                                   (1000, 300, 700)])
def test_ops_gemm_pads_like_the_reference(m, k, n):
    """ops.gemm at shapes that are not multiples of 128: the reference's
    padded Pallas path (where its interpreted grid stays small) and its
    oracle."""
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    got = tops.gemm(x, y, device="cpu")
    assert got.shape == (m, n)
    want = jops.gemm(jnp.asarray(x), jnp.asarray(y), backend="xla")
    assert_close(got.numpy(), np.asarray(want), rtol=1e-4, name="oracle")
    if m * n <= 200 * 200:
        want = jops.gemm(jnp.asarray(x), jnp.asarray(y), backend="pallas")
        assert_close(got.numpy(), np.asarray(want), rtol=1e-4,
                     name="pallas")


def test_gemm_bf16_matches_reference():
    """bf16 in, bf16 out, a float32 accumulator: the reference's Pallas
    kernel on the same bf16 inputs."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    y = rng.standard_normal((96, 32)).astype(np.float32)
    got = tops.gemm(_t(x).bfloat16(), _t(y).bfloat16(), device="cpu")
    assert got.dtype == torch.bfloat16
    want = gemm_pallas(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(y, jnp.bfloat16), interpret=True)
    assert_close(got.float().numpy(), _np(want), rtol=BF16_RTOL,
                 name="bf16 gemm")


def test_gemm_guards():
    with pytest.raises(ValueError):
        tgemm.gemm_fused(torch.ones((4, 5)), torch.ones((6, 3)))
    with pytest.raises(ValueError):
        tops.gemm(np.ones((4, 5), np.float32), np.ones((6, 3), np.float32),
                  device="cpu")
    with pytest.raises(TypeError):
        tgemm.gemm_fused(torch.ones((4, 5)), torch.ones((5, 3)).double())
    with pytest.raises(TypeError):
        tgemm.gemm_fused(torch.ones((4, 5)),
                         torch.ones((5, 3), dtype=torch.bfloat16))


# ---------------- K20 flash attention ----------------

def _qkv(rng, b, h, hkv, s, d):
    return ((rng.standard_normal((b, h, s, d)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _peaked_qkv(rng, b, h, hkv, s, d):
    """Peaked scores: q and k at sigma 1.5 (scaled scores of sigma ~2.25,
    so each row's max moves from kv tile to kv tile), q with a common
    component 3 / sqrt(D) per element, and the key at s - 1 - s // 16,
    in the last kv tile, set to 6 per element: a score of ~18 planted
    late, where the running max jumps and all before must be rescaled."""
    q = rng.standard_normal((b, h, s, d)) * 1.5 + 3.0 / np.sqrt(d)
    k = rng.standard_normal((b, hkv, s, d)) * 1.5
    k[:, :, s - 1 - s // 16] = 6.0
    v = rng.standard_normal((b, hkv, s, d))
    return tuple(a.astype(np.float32) for a in (q, k, v))


# element by element, |got - want| <= rtol (softmax(q k^T) |v| + |want|):
# rounding p to bf16 moves each term of P V by at most 2^-8 of itself and
# the answer rounds to 2^-8 of itself, 5e-3 covering both; float32
# differs by summation order and exp's last bits only
ATTN_RTOLS = {"float32": 1e-4, "bfloat16": 5e-3}


def _attn_close(got, want, scale, rtol, name):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    tol = rtol * (np.abs(scale) + np.abs(want))
    worst = float(np.max(err / tol))
    assert worst <= 1.0, f"{name}: |diff| reaches {worst:.3g} of its limit"


def test_flash_registry_case_matches_pallas_and_oracle():
    """The registry case (1, 2, 128, 64), causal: identical inputs from
    the two packages' generators, the plain version against the
    reference's Pallas kernel and both oracles at the spec's rtol."""
    spec = TK.get("flash_attention")
    targs = spec.make_case(np.random.default_rng(0), 128)
    jargs = RK.get("flash_attention").make_case(np.random.default_rng(0),
                                                128)
    for t, j in zip(targs, jargs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    got = spec.kernel(*targs).numpy()
    assert_close(got, np.asarray(flash_attention_pallas(
        *jargs, causal=True, interpret=True)), rtol=spec.rtol, name="pallas")
    assert_close(got, np.asarray(jref.mha(*jargs, causal=True)),
                 rtol=spec.rtol, name="reference oracle")
    assert_close(spec.run_oracle(*targs).numpy(),
                 np.asarray(jref.mha(*jargs, causal=True)), rtol=1e-4,
                 name="oracles")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 4, 2, 256, 16),
                                         (2, 4, 2, 96, 8),
                                         (1, 2, 1, 8, 8)])
def test_flash_gqa_matches_pallas(b, h, hkv, s, d, causal):
    """GQA (two query heads a KV head), S a multiple of 128 and S below
    it, causal and not, against the reference's Pallas kernel and
    ``ref.mha``."""
    q, k, v = _qkv(np.random.default_rng(s + d), b, h, hkv, s, d)
    got = tops.flash_attention(q, k, v, causal=causal, device="cpu")
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  interpret=True)
    assert_close(got.numpy(), np.asarray(want), rtol=1e-3, name="pallas")
    assert_close(got.numpy(), np.asarray(jref.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)),
        rtol=1e-3, name="oracle")
    assert_close(tref.mha(_t(q), _t(k), _t(v), causal=causal).numpy(),
                 got.numpy(), rtol=1e-3, name="port oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 4, 2, 256, 16),
                                         (1, 2, 1, 512, 8)])
def test_flash_peaked_scores_match_pallas(b, h, hkv, s, d, causal, dtype):
    """Peaked scores with a large one planted in the last kv tile: the
    online softmax must rescale what it carried, element by element
    within what p's rounding allows, against the reference's Pallas
    kernel and the float32 oracle on the same inputs."""
    q, k, v = _peaked_qkv(np.random.default_rng(s + d), b, h, hkv, s, d)
    jdt = getattr(jnp, dtype)
    got = tops.flash_attention(*(_t(a).to(getattr(torch, dtype))
                                 for a in (q, k, v)),
                               causal=causal, device="cpu").float().numpy()
    j = tuple(jnp.asarray(a, jdt) for a in (q, k, v))
    wide = tuple(jnp.asarray(a, jnp.float32) for a in j)
    scale = _np(jref.mha(wide[0], wide[1], jnp.abs(wide[2]), causal=causal))
    rtol = ATTN_RTOLS[dtype]
    _attn_close(got, _np(flash_attention_pallas(*j, causal=causal,
                                                interpret=True)),
                scale, rtol, "pallas")
    _attn_close(got, _np(jref.mha(*wide, causal=causal)), scale, rtol,
                "oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(5, 4), (5, 12), (100, 4), (100, 12)])
def test_flash_ragged_tiles_and_narrow_heads_match_pallas(s, d, causal,
                                                          dtype):
    """The shapes the kernel's tensor-core form tiles raggedly: S = 5 and
    100 (one q and kv tile of S rows in the reference, a ragged tile of
    the kernel's 64) and D = 4, 12 (not multiples of 8), GQA 4/2, on
    peaked scores: the plain version against the reference's Pallas
    kernel and the float32 oracle, element by element."""
    q, k, v = _peaked_qkv(np.random.default_rng(s + d), 1, 4, 2, s, d)
    jdt = getattr(jnp, dtype)
    got = tops.flash_attention(*(_t(a).to(getattr(torch, dtype))
                                 for a in (q, k, v)),
                               causal=causal, device="cpu").float().numpy()
    j = tuple(jnp.asarray(a, jdt) for a in (q, k, v))
    wide = tuple(jnp.asarray(a, jnp.float32) for a in j)
    scale = _np(jref.mha(wide[0], wide[1], jnp.abs(wide[2]), causal=causal))
    rtol = ATTN_RTOLS[dtype]
    _attn_close(got, _np(flash_attention_pallas(*j, causal=causal,
                                                interpret=True)),
                scale, rtol, "pallas")
    _attn_close(got, _np(jref.mha(*wide, causal=causal)), scale, rtol,
                "oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(100, 12), (256, 16)])
def test_flash_strided_route_equals_contiguous_on_cpu(s, d, causal, dtype):
    """ops.flash_attention on (B, S, H, D) tensors handed over as
    transposed views, as the models call it: no copy is asked for, the
    answer comes back in q's layout (its transpose is contiguous) and
    equals the answer on contiguous (B, H, S, D) copies bit for bit, as
    does a view whose last axis is strided."""
    rng = np.random.default_rng(s)
    dt = getattr(torch, dtype)
    q, k, v = (_t(a).to(dt).transpose(1, 2).contiguous().transpose(1, 2)
               for a in _peaked_qkv(rng, 2, 4, 2, s, d))
    assert not q.is_contiguous()
    got = tops.flash_attention(q, k, v, causal=causal, device="cpu")
    want = tops.flash_attention(*(t.contiguous() for t in (q, k, v)),
                                causal=causal, device="cpu")
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, want)
    qt = q.contiguous().transpose(-1, -2).contiguous().transpose(-1, -2)
    assert qt.stride(-1) != 1
    assert torch.equal(tattn.flash_attention_fused(qt, k, v, causal=causal),
                       want)


def test_flash_bf16_matches_pallas():
    """bf16 inputs: scores and softmax in float32, p rounded to bf16
    before P V, as the reference's kernel does."""
    q, k, v = _qkv(np.random.default_rng(5), 2, 4, 2, 96, 8)
    got = tops.flash_attention(*(_t(a).bfloat16() for a in (q, k, v)),
                               device="cpu")
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in (q, k, v)), interpret=True)
    assert_close(got.float().numpy(), _np(want), rtol=BF16_RTOL,
                 name="bf16 flash")


def test_flash_explicit_scale_and_tiles():
    """An explicit scale and smaller tiles (bq = bkv = 32) change only
    the rounding, as in the reference."""
    q, k, v = _qkv(np.random.default_rng(6), 1, 2, 2, 128, 16)
    got = tops.flash_attention(q, k, v, scale=0.1, bq=32, bkv=32,
                               device="cpu")
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=0.1, bq=32, bkv=32,
                                  interpret=True)
    assert_close(got.numpy(), np.asarray(want), rtol=1e-3, name="tiles")


@pytest.mark.parametrize("shape_q,shape_k,causal", [
    ((1, 2, 200, 64), (1, 2, 200, 64), True),     # 200 % 128 != 0
    ((1, 3, 128, 64), (1, 2, 128, 64), True),     # 3 % 2 != 0
    ((1, 2, 128, 64), (1, 2, 256, 64), True),     # causal, not square
])
def test_flash_guards_raise_where_the_reference_asserts(shape_q, shape_k,
                                                        causal):
    q = np.zeros(shape_q, np.float32)
    k = np.zeros(shape_k, np.float32)
    with pytest.raises(AssertionError):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(k), causal=causal,
                               interpret=True)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, k, causal=causal, device="cpu")


def test_flash_non_causal_rectangular():
    """Non-causal attention over more keys than queries (Sq 128, Skv
    256), as cross-attention would call it."""
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((1, 2, 128, 16)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((1, 2, 256, 16)) * 0.3).astype(np.float32)
    v = rng.standard_normal((1, 2, 256, 16)).astype(np.float32)
    got = tops.flash_attention(q, k, v, causal=False, device="cpu")
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False,
                                  interpret=True)
    assert_close(got.numpy(), np.asarray(want), rtol=1e-3, name="rect")


def test_wrappers_take_the_plain_version_only_on_the_cpu(monkeypatch):
    """A CPU tensor takes the plain version without touching the
    kernels' library; a CUDA device is never asked for."""
    from repro_torch.kernels import common
    monkeypatch.setattr(common, "load_library", lambda: pytest.fail(
        "the CPU path loaded the CUDA library"))
    x = torch.ones((3, 4))
    assert torch.equal(tgemm.gemm_fused(x, x.T.contiguous()),
                       tgemm.gemm_plain(x, x.T.contiguous()))
    q = torch.ones((1, 2, 8, 8))
    assert torch.equal(tattn.flash_attention_fused(q, q, q),
                       tattn.flash_attention_plain(q, q, q))
