"""K21, the chunked SSD scan, its ``ops`` / ``ref`` functions and registry
spec, ``core.fuse_scan``, and the Mamba2, mLSTM and sLSTM blocks of the
port against the JAX reference.

The same numpy inputs, made from a seed, go through the reference's
Pallas kernel (interpret mode on the CPU, as ``tests/test_kernels.py``
runs it), its ``ops._ssm_chunked_xla`` path, its sequential oracle and
its model blocks, and through the port's wrappers on CPU tensors, which
run the kernel's plain PyTorch version.  Tolerances:

* the chunked scan against the chunked scan (Pallas, xla, plain): 1e-5
  of the largest answer — float32 sums taken in another order only;
* against the sequential oracle: the spec's 1e-3 (the chunked form
  regroups the recurrence's products through exp(la_i - la_j));
* the blocks in float32 on carried weights: 1e-4 (products and
  transcendental functions differ in the last bits only);
* bfloat16 scans: 2e-2, each answer rounded once to 2^-8 of its size.

The CUDA kernel is held against this plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.configs import get_smoke as rget_smoke  # noqa: E402
from repro.core.dependence import fuse_scan as jfuse_scan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import fuse_scan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

from conftest import assert_close  # noqa: E402

tscan = importlib.import_module("repro_torch.kernels.ssm_scan")

CHUNKED_RTOL = 1e-5
ORACLE_RTOL = 1e-3
BLOCK_RTOL = 1e-4
BF16_RTOL = 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _case(seed, b, h, s, p, n, per_head, decay=(0.8, 0.999)):
    """Kernel-layout inputs x (B, H, S, P), a (B, H, S), b/c (B, S, N) or
    (B, H, S, N), float32 numpy."""
    rng = np.random.default_rng(seed)
    bc = (b, h, s, n) if per_head else (b, s, n)
    return (rng.standard_normal((b, h, s, p)).astype(np.float32),
            rng.uniform(*decay, (b, h, s)).astype(np.float32),
            rng.standard_normal(bc).astype(np.float32),
            rng.standard_normal(bc).astype(np.float32))


def _to_seq(x, a, b, c):
    """Kernel layout -> the ops / oracle layout (B, S, H, ...)."""
    mv = lambda t: np.ascontiguousarray(np.moveaxis(t, 1, 2))
    return mv(x), mv(a), (mv(b) if b.ndim == 4 else b), \
        (mv(c) if c.ndim == 4 else c)


# (b, h, s, p, n, per_head, chunk): shared and per-head B/C, one chunk
# and several, S < chunk, an odd P and a chunk that is not a power of two
SCAN_CASES = [(1, 2, 64, 4, 8, False, 16), (2, 3, 64, 8, 8, True, 16),
              (1, 2, 32, 9, 8, False, 32), (1, 2, 48, 9, 6, True, 128),
              (2, 2, 96, 5, 8, True, 24), (1, 1, 16, 3, 4, False, 16)]


@pytest.mark.parametrize("b,h,s,p,n,per_head,chunk", SCAN_CASES)
def test_plain_scan_matches_pallas_xla_and_oracle(b, h, s, p, n, per_head,
                                                  chunk):
    x, a, bb, cc = _case(s + p, b, h, s, p, n, per_head)
    got_y, got_h = tscan.ssm_scan_fused(*map(_t, (x, a, bb, cc)),
                                        chunk=chunk)
    assert got_y.shape == (b, h, s, p) and got_h.shape == (b, h, n, p)
    py, ph = ssm_scan_pallas(*map(jnp.asarray, (x, a, bb, cc)), chunk=chunk,
                             interpret=True)
    assert_close(got_y.numpy(), np.asarray(py), rtol=CHUNKED_RTOL,
                 name="y vs pallas")
    assert_close(got_h.numpy(), np.asarray(ph), rtol=CHUNKED_RTOL,
                 name="h vs pallas")
    seq = _to_seq(x, a, bb, cc)
    xy, xh = jops._ssm_chunked_xla(*map(jnp.asarray, seq), chunk=chunk)
    oy, oh = tops.ssm_scan(*seq, chunk=chunk, device="cpu")
    assert_close(oy.numpy(), np.asarray(xy), rtol=CHUNKED_RTOL,
                 name="ops y vs xla")
    assert_close(oh.numpy(), np.asarray(xh), rtol=CHUNKED_RTOL,
                 name="ops h vs xla")
    ry, rh = tref.ssm_scan(*map(_t, seq))
    jy, jh = jref.ssm_scan(*map(jnp.asarray, seq))
    assert_close(ry.numpy(), np.asarray(jy), rtol=CHUNKED_RTOL,
                 name="oracle vs oracle")
    assert_close(rh.numpy(), np.asarray(jh), rtol=CHUNKED_RTOL,
                 name="oracle h vs oracle h")
    assert_close(oy.numpy(), ry.numpy(), rtol=ORACLE_RTOL, name="vs oracle")
    assert_close(oh.numpy(), rh.numpy(), rtol=ORACLE_RTOL,
                 name="h vs oracle")


@pytest.mark.parametrize("decay", [(1.0, 1.0), (0.0, 0.0)],
                         ids=["one", "zero"])
def test_plain_scan_at_the_decay_limits(decay):
    """Decays of exactly 1 (no forgetting) and 0 (the 1e-20 clamp) give
    the reference's answers."""
    x, a, bb, cc = _case(5, 1, 2, 64, 4, 8, False, decay=decay)
    got_y, got_h = tscan.ssm_scan_fused(*map(_t, (x, a, bb, cc)), chunk=16)
    py, ph = ssm_scan_pallas(*map(jnp.asarray, (x, a, bb, cc)), chunk=16,
                             interpret=True)
    assert np.isfinite(got_y.numpy()).all()
    assert_close(got_y.numpy(), np.asarray(py), rtol=CHUNKED_RTOL,
                 name="y vs pallas")
    assert_close(got_h.numpy(), np.asarray(ph), rtol=CHUNKED_RTOL,
                 name="h vs pallas")
    ry, _ = tref.ssm_scan(*map(_t, _to_seq(x, a, bb, cc)))
    assert_close(np.moveaxis(got_y.numpy(), 1, 2), ry.numpy(),
                 rtol=ORACLE_RTOL, name="vs oracle")


def test_plain_scan_in_bf16_rounds_once():
    """bf16 in and out, float32 inside: the answer is the float32 scan of
    the bf16 inputs rounded once."""
    x, a, bb, cc = (_t(v).bfloat16() for v in _case(7, 1, 2, 64, 9, 8,
                                                     True))
    got_y, got_h = tscan.ssm_scan_fused(x, a, bb, cc, chunk=16)
    assert got_y.dtype == got_h.dtype == torch.bfloat16
    want_y, want_h = tscan.ssm_scan_plain(*(t.float() for t in (x, a, bb,
                                                                  cc)),
                                          chunk=16)
    assert_close(got_y.float().numpy(), want_y.numpy(), rtol=BF16_RTOL,
                 name="bf16 y")
    assert_close(got_h.float().numpy(), want_h.numpy(), rtol=BF16_RTOL,
                 name="bf16 h")


def test_strided_views_need_no_copy():
    """ops.ssm_scan hands the kernel (B, H, S, P) views of its (B, S, H,
    P) inputs; the answer equals the one on contiguous copies."""
    x, a, bb, cc = _case(3, 2, 3, 32, 5, 4, True)
    seq = [_t(v) for v in _to_seq(x, a, bb, cc)]
    views = [t.transpose(1, 2) for t in seq]
    assert not views[0].is_contiguous()
    got = tscan.ssm_scan_fused(*views, chunk=16)
    want = tscan.ssm_scan_fused(*(v.contiguous() for v in views), chunk=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("s,chunk", [(40, 16), (100, 64)])
def test_ragged_sequence_raises(s, chunk):
    case = _case(0, 1, 2, s, 4, 8, False)
    with pytest.raises(ValueError, match="divide"):
        tscan.ssm_scan_fused(*map(_t, case), chunk=chunk)
    with pytest.raises(ValueError, match="divide"):
        tops.ssm_scan(*_to_seq(*case), chunk=chunk, device="cpu")


def test_wrapper_refuses_bad_arguments():
    x, a, bb, cc = map(_t, _case(0, 1, 2, 16, 4, 8, False))
    with pytest.raises(ValueError):
        tscan.ssm_scan_fused(x, a[:, :1], bb, cc)
    with pytest.raises(ValueError):
        tscan.ssm_scan_fused(x, a, bb, cc[..., :4])
    with pytest.raises(TypeError):
        tscan.ssm_scan_fused(x, a.double(), bb, cc)


def test_registry_spec_matches_the_reference():
    """The ``ssm_scan`` spec: the reference's case, sizes, rtol, kind and
    stream; the port's run (chunk 16) against its oracle and the
    reference's Pallas run."""
    t, j = TK.get("ssm_scan"), RK.get("ssm_scan")
    assert (t.sizes, t.rtol, t.kind) == (j.sizes, j.rtol, j.kind)
    n = t.sizes[0]
    assert t.stream(n).capability == j.stream(n).capability
    assert t.stream(n).length() == j.stream(n).length()
    targs = t.make_case(np.random.default_rng(n), n)
    jargs = j.make_case(np.random.default_rng(n), n)
    for ta, ja in zip(targs, jargs):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    got = t.run_kernel(*targs)
    for g, w in zip(got, t.run_oracle(*targs)):
        assert_close(g.numpy(), w.numpy(), rtol=t.rtol, name="vs oracle")
    for g, w in zip(got, j.run_pallas(*jargs)):
        assert_close(g.numpy(), np.asarray(w), rtol=CHUNKED_RTOL,
                     name="vs pallas")


# ---------------- fuse_scan ----------------

def test_fuse_scan_is_lax_scan():
    """The carried FIFO, the stacked ys and a tree of xs, as lax.scan."""
    def step(carry, x):
        inva = 1.0 / carry
        return carry + inva * x[0], (inva, x[1] * carry)

    xs = np.arange(1.0, 6.0, dtype=np.float32)
    ys2 = np.arange(10.0, dtype=np.float32).reshape(5, 2)
    final, (inv, prod) = fuse_scan(step, torch.tensor(2.0),
                                   xs=(_t(xs), _t(ys2)))
    jfinal, (jinv, jprod) = jfuse_scan(step, jnp.asarray(2.0),
                                       xs=(jnp.asarray(xs), jnp.asarray(ys2)))
    assert_close(final.numpy(), np.asarray(jfinal), rtol=1e-6, name="carry")
    assert_close(inv.numpy(), np.asarray(jinv), rtol=1e-6, name="ys")
    assert prod.shape == jprod.shape == (5, 2)
    assert_close(prod.numpy(), np.asarray(jprod), rtol=1e-6, name="ys2")


def test_fuse_scan_zero_length_is_identity():
    """lax.scan's zero-trip contract: the initial carry and empty ys."""
    step = lambda c, x: (c + 1.0, c)
    final, ys = fuse_scan(step, torch.tensor(2.5), length=0)
    assert float(final) == 2.5 and tuple(ys.shape) == (0,)
    final, ys = fuse_scan(step, torch.tensor(2.5), xs=torch.zeros((0,)))
    assert float(final) == 2.5 and tuple(ys.shape) == (0,)
    final, ys = fuse_scan(lambda c, x: (c, c * 2), torch.ones(3), length=0)
    assert tuple(ys.shape) == (0, 3)
    with pytest.raises(ValueError):
        fuse_scan(step, torch.tensor(0.0))


def test_fuse_scan_length_without_xs():
    final, ys = fuse_scan(lambda c, x: (c * 2, c), torch.tensor(1.0),
                          length=4)
    jfinal, jys = jfuse_scan(lambda c, x: (c * 2, c), jnp.asarray(1.0),
                             length=4)
    assert float(final) == float(jfinal) == 16.0
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))


# ---------------- blocks on carried weights ----------------

def _carry(tree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), tree)


def _cfgs(arch):
    jcfg = dataclasses.replace(rget_smoke(arch), compute_dtype="float32")
    return jcfg, dataclasses.replace(get_smoke(arch),
                                     compute_dtype="float32")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


def test_mamba_block_train_and_decode_match_the_reference():
    jcfg, cfg = _cfgs("zamba2-2.7b")
    jp = JS.init_mamba(jax.random.key(3), jcfg.d_model, jcfg.ssm)
    # nonzero decay and skip parameters, so each path is exercised
    rng = np.random.default_rng(4)
    h = jcfg.ssm.heads
    jp = dict(jp, a_log=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
              d_skip=jnp.asarray(rng.normal(1, 0.5, h), jnp.float32))
    p = _carry(jp)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p_, x_: JS.mamba_train(p_, jcfg, x_))(
        jp, jnp.asarray(x))
    got = TS.mamba_train(p, cfg, _t(x))
    assert _rel(got.numpy(), want) < BLOCK_RTOL
    jc = JS.init_mamba_cache(jcfg, 2, 1)
    tc = TS.init_mamba_cache(cfg, 2, 1)
    jst, jcv = jc["state"][0], jc["conv"][0]
    st, cv = tc["state"][0], tc["conv"][0]
    jdecode = jax.jit(lambda *a: JS.mamba_decode(a[0], jcfg, *a[1:]))
    for t in range(5):
        jo, jst, jcv = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcv)
        o, st, cv = TS.mamba_decode(p, cfg, _t(x[:, t:t + 1]), st, cv)
        assert _rel(o.numpy(), jo) < BLOCK_RTOL
        # token by token equals the parallel form, row t
        assert _rel(o[:, 0].numpy(), want[:, t]) < BLOCK_RTOL
    assert _rel(st.numpy(), jst) < BLOCK_RTOL
    assert _rel(cv.numpy(), jcv) < BLOCK_RTOL


@pytest.mark.parametrize("dt_bias", [0.0, -6.0])
def test_mamba_decode_rounds_where_the_prefill_rounds(dt_bias):
    """In bfloat16 the decode step, token by token, gives every element of
    ``mamba_train``'s answer to within one rounding of it (2^-8 of
    itself): its conv taps, decay and x * dt round where the prefill
    rounds them for the scan.  ``dt_bias`` -6 puts the decays within 2^-8
    of 1, where the rounding decides how much a state decays.  The
    reference's decode step, which keeps the decay and x * dt in float32
    and sums the taps at once, misses this on most elements."""
    jcfg = rget_smoke("zamba2-2.7b")
    cfg = get_smoke("zamba2-2.7b")
    assert cfg.compute_dtype == jcfg.compute_dtype == "bfloat16"
    jp = JS.init_mamba(jax.random.key(3), jcfg.d_model, jcfg.ssm)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], dt_bias))
    jp = {k: v.astype(jnp.bfloat16) if v.ndim >= 2 else v
          for k, v in jp.items()}
    p = {k: _t(np.asarray(v, np.float32)).to(getattr(torch, v.dtype.name))
         for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 32, jcfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = _t(np.asarray(jx, np.float32)).to(torch.bfloat16)
    want = TS.mamba_train(p, cfg, tx).float().numpy()
    tc, jc = TS.init_mamba_cache(cfg, 2, 1), JS.init_mamba_cache(jcfg, 2, 1)
    st, cv, jst, jcv = tc["state"][0], tc["conv"][0], jc["state"][0], \
        jc["conv"][0]
    got, jgot = [], []
    for t in range(x.shape[1]):
        o, st, cv = TS.mamba_decode(p, cfg, tx[:, t:t + 1], st, cv)
        jo, jst, jcv = JS.mamba_decode(jp, jcfg, jx[:, t:t + 1], jst, jcv)
        got.append(o.float().numpy())
        jgot.append(np.asarray(jo, np.float32))
    one_rounding = 2.0 ** -8 * np.abs(want)
    assert np.all(np.abs(np.concatenate(got, 1) - want) <= one_rounding)
    missed = np.abs(np.concatenate(jgot, 1) - want) > one_rounding
    assert missed.mean() > 0.5


def test_mlstm_and_slstm_blocks_match_the_reference():
    jcfg, cfg = _cfgs("xlstm-125m")
    d, nh = jcfg.d_model, jcfg.n_heads
    jm = JX.init_mlstm(jax.random.key(5), d, jcfg.xlstm)
    js = JX.init_slstm(jax.random.key(6), d, jcfg.xlstm)
    pm, ps = _carry(jm), _carry(js)
    x = np.random.default_rng(7).standard_normal((2, 64, d)) \
        .astype(np.float32)
    wm = jax.jit(lambda p_, x_: JX.mlstm_train(p_, jcfg, x_, nh))(
        jm, jnp.asarray(x))
    assert _rel(TX.mlstm_train(pm, cfg, _t(x), nh).numpy(), wm) \
        < BLOCK_RTOL
    ws = jax.jit(lambda p_, x_: JX.slstm_train(p_, jcfg, x_))(
        js, jnp.asarray(x))
    assert _rel(TX.slstm_train(ps, cfg, _t(x)).numpy(), ws) < BLOCK_RTOL
    jms = JX.init_mlstm_state(jcfg, d, 2, nh)
    ms = TX.init_mlstm_state(cfg, d, 2, nh)
    assert ms.shape == jms.shape
    jss = JX.init_slstm_state(d, 2)
    ss = TX.init_slstm_state(d, 2)
    mdecode = jax.jit(lambda p_, x_, s_: JX.mlstm_decode(p_, jcfg, x_, s_,
                                                          nh))
    sdecode = jax.jit(lambda p_, x_, s_: JX.slstm_decode(p_, jcfg, x_, s_))
    for t in range(4):
        xt = x[:, t:t + 1]
        jo, jms = mdecode(jm, jnp.asarray(xt), jms)
        o, ms = TX.mlstm_decode(pm, cfg, _t(xt), ms, nh)
        assert _rel(o.numpy(), jo) < BLOCK_RTOL
        assert _rel(o[:, 0].numpy(), wm[:, t]) < BLOCK_RTOL
        jo, jss = sdecode(js, jnp.asarray(xt), jss)
        o, ss = TX.slstm_decode(ps, cfg, _t(xt), ss)
        assert _rel(o.numpy(), jo) < BLOCK_RTOL
        assert _rel(o[:, 0].numpy(), ws[:, t]) < BLOCK_RTOL
    assert _rel(ms.numpy(), jms) < BLOCK_RTOL
    for k in ("h", "c", "n", "m"):
        assert _rel(ss[k].numpy(), jss[k]) < BLOCK_RTOL


def test_softplus_is_logaddexp():
    """The reference's softplus, not torch's (linear above 20)."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0], np.float32)
    assert_close(TS.softplus(_t(x)).numpy(),
                 np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                 name="softplus")


def test_ordered_dep_rates_match_the_reference():
    """OrderedDep's rate fields and RegionGraph.total_consumptions: an
    inductive consumer reading the value of outer iteration k 8 - k
    times, as the reference's (tests/test_core_graph.py)."""
    from fractions import Fraction

    from repro.core.dependence import OrderedDep as JDep
    from repro.core.dependence import Region as JRegion
    from repro.core.dependence import RegionGraph as JGraph
    from repro_torch.core import OrderedDep, Region, RegionGraph
    kw = dict(cons_rate=Fraction(8), cons_stretch=Fraction(-1))
    d, jd = OrderedDep("p", "m", **kw), JDep("p", "m", **kw)
    assert [d.consumptions_at(k) for k in range(10)] \
        == [jd.consumptions_at(k) for k in range(10)] \
        == [8, 7, 6, 5, 4, 3, 2, 1, 0, 0]
    regions = [Region("p", None), Region("m", None, critical=True)]
    g = RegionGraph(regions=regions, deps=[d])
    jg = JGraph(regions=[JRegion("p", None), JRegion("m", None, True)],
                deps=[jd])
    assert g.total_consumptions(d, 8) == jg.total_consumptions(jd, 8) == 36
