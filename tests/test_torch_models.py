"""The port's dense LM (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference: configs, layers, the four attention paths,
``prefill`` and ``decode_step`` on weights carried across.

The reference's parameters (``T.init_params`` from a fixed key) become
the port's through ``params_from_numpy``, so both compute the same
function on the same numpy tokens.  Tolerances, each a relative error
``max|got - want| / max|want|`` of the logits:

* float32 compute (``dataclasses.replace(cfg, compute_dtype="float32")``):
  1e-4 — the two frameworks' float32 products and transcendental
  functions differ in summation order and in the last bits only;
* bfloat16 compute (the configs' own): 5e-2 with the argmax on at least
  half the rows — the reference's own rule for bf16 paths that round at
  different places (``tests/test_models.py::
  test_prefill_decode_consistency``); bf16 rounds after each product in
  both frameworks, but not at identical places.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import get_smoke as rget_smoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mlp as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

from conftest import assert_close  # noqa: E402

DENSE = ["phi4-mini-3.8b", "qwen3-14b", "nemotron-4-15b"]
F32_RTOL = 1e-4
BF16_RTOL = 5e-2
B, S = 2, 32


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


def _pair(arch, dtype, seed=0):
    """(reference cfg, params) and (port cfg, params) of ``arch``'s smoke
    config at compute ``dtype``, the port's carried across."""
    jcfg = dataclasses.replace(rget_smoke(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=dtype)
    jp = JT.init_params(jax.random.key(seed), jcfg)
    p = TT.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")
    return jcfg, jp, cfg, p


def _check(got, want, dtype, name):
    rel = _rel(got, want)
    if dtype == "float32":
        assert rel < F32_RTOL, f"{name}: rel err {rel:.3e}"
    else:
        assert rel < BF16_RTOL, f"{name}: rel err {rel:.3e}"
        agree = (np.asarray(got).argmax(-1) == np.asarray(want).argmax(-1))
        assert agree.mean() >= 0.5, f"{name}: argmax {agree}"


# ---------------- configs ----------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    """All ten configurations, full and smoke, field for field."""
    assert ARCHS == RARCHS
    for mine, theirs in ((get_config(arch), rget_config(arch)),
                         (get_smoke(arch), rget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference(arch):
    for get, rget in ((get_config, rget_config), (get_smoke, rget_smoke)):
        assert get(arch).param_count() == rget(arch).param_count()
        assert get(arch).active_param_count() \
            == rget(arch).active_param_count()


def test_phi4_mini_full_width():
    cfg = get_config("phi4-mini-3.8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            cfg.d_ff, cfg.vocab, cfg.act) == (32, 3072, 24, 8, 128, 8192,
                                              200064, "swiglu")
    assert cfg.param_count() == 4_450_418_688


def test_params_from_numpy_maps_every_layer():
    """The reference's stacked (L, ...) arrays land in the port's
    per-layer dicts, value for value, and the port's own init builds the
    same tree of shapes."""
    jcfg, jp, cfg, p = _pair("qwen3-14b", "bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    assert len(p["layers"]) == cfg.n_layers
    for i, lp in enumerate(p["layers"]):
        for blk in ("attn", "mlp"):
            for name, w in lp[blk].items():
                np.testing.assert_array_equal(
                    w.numpy(), tree["layers"][blk][name][i])
        np.testing.assert_array_equal(lp["ln1"].numpy(),
                                      tree["layers"]["ln1"][i])
    for name in ("embed", "ln_f", "lm_head"):
        np.testing.assert_array_equal(p[name].numpy(), tree[name])
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = TT.init_params(gen, cfg)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(mine["layers"][0]) == shapes(p["layers"][0])
    assert mine["embed"].shape == p["embed"].shape
    assert all(w.dtype == torch.float32 for w in mine["layers"][0]["mlp"]
               .values())


def test_cast_params_gives_the_values_of_each_use_cast():
    _, _, cfg, p = _pair("phi4-mini-3.8b", "bfloat16")
    c = TT.cast_params(p, cfg)
    w = p["layers"][1]["attn"]["wq"]
    assert c["layers"][1]["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(c["layers"][1]["attn"]["wq"], w.to(torch.bfloat16))
    assert c["layers"][1]["ln1"] is p["layers"][1]["ln1"]     # f32 kept


@pytest.mark.parametrize("family_arch", ["dbrx-132b",
                                         "seamless-m4t-large-v2",
                                         "internvl2-76b"])
def test_later_families_raise_naming_their_slice(family_arch):
    with pytest.raises(NotImplementedError, match="later slice"):
        TT.init_params(torch.Generator(), get_smoke(family_arch))


# ---------------- layers ----------------

def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
    assert_close(TL.rms_norm(_t(x), _t(scale)).numpy(),
                 np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
                 rtol=1e-5, name="rms_norm")
    assert_close(TL.apply_rope(_t(x), _t(pos), 1e4).numpy(),
                 np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          1e4)), rtol=1e-5, name="rope")
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7))
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = TL.softmax_xent(_t(logits), _t(labels),
                              None if m is None else _t(m))
        want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        assert abs(float(got) - float(want)) < 1e-5


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_matches_the_reference(act):
    p = JM.init_mlp(jax.random.key(0), 16, 24, act)
    x = np.random.default_rng(1).standard_normal((2, 3, 16)).astype(
        np.float32)
    got = TM.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    want = JM.mlp(p, jnp.asarray(x), act)
    assert_close(got.numpy(), np.asarray(want), rtol=1e-5, name=act)
    with pytest.raises(NotImplementedError, match="later slice"):
        TM.moe(None, None, None)


# ---------------- attention ----------------

ATTN_CFG = get_smoke("qwen3-14b")


def _attn_qkv(seed=0, s=64):
    rng = np.random.default_rng(seed)
    h, kv, dh = ATTN_CFG.n_heads, ATTN_CFG.n_kv, ATTN_CFG.d_head
    return ((rng.standard_normal((B, s, h, dh)) * .3).astype(np.float32),
            (rng.standard_normal((B, s, kv, dh)) * .3).astype(np.float32),
            rng.standard_normal((B, s, kv, dh)).astype(np.float32))


def _gqa_oracle(q, k, v, causal=True):
    g = q.shape[2] // k.shape[2]
    o = tref.mha(_t(q).transpose(1, 2),
                 _t(k).repeat_interleave(g, 2).transpose(1, 2),
                 _t(v).repeat_interleave(g, 2).transpose(1, 2),
                 causal=causal)
    return o.transpose(1, 2).numpy()


@pytest.mark.parametrize("impl,extra", [
    ("xla", {}),
    ("chunked", {"attn_chunk": 16}),
    ("chunked", {"attn_chunk": 64}),
    ("banded", {"attn_bands": 4}),
    ("banded", {"attn_bands": 8}),
    ("banded", {"attn_bands": 4, "attn_chunk": 8}),
    ("banded", {"attn_bands": 2, "attn_chunk": 8}),
    ("flash", {}),
])
def test_attend_train_impls_equal_each_other(impl, extra):
    """The four train-path impls against the GQA oracle and against the
    reference's same impl (the reference has no interpret path for
    flash at this S; its xla impl stands in)."""
    cfg = dataclasses.replace(ATTN_CFG, attn_impl=impl, **extra)
    q, k, v = _attn_qkv()
    got = TA.attend_train(_t(q), _t(k), _t(v), cfg).numpy()
    assert_close(got, _gqa_oracle(q, k, v), rtol=1e-4, name=impl)
    jimpl = "xla" if impl == "flash" else impl
    jcfg = dataclasses.replace(rget_smoke("qwen3-14b"), attn_impl=jimpl,
                               **extra)
    want = jax.jit(lambda q, k, v: JA.attend_train(q, k, v, jcfg))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert_close(got, np.asarray(want), rtol=1e-4, name=f"{impl} vs ref")


def test_attend_non_causal_and_non_divisible_chunk():
    cfg = dataclasses.replace(ATTN_CFG, attn_impl="xla")
    q, k, v = _attn_qkv(1)
    got = TA.attend_train(_t(q), _t(k), _t(v), cfg, causal=False).numpy()
    assert_close(got, _gqa_oracle(q, k, v, causal=False), rtol=1e-4)
    cfg = dataclasses.replace(ATTN_CFG, attn_impl="chunked", attn_chunk=48)
    q, k, v = _attn_qkv(2, s=68)           # divisors <= 48: 34
    got = TA.attend_train(_t(q), _t(k), _t(v), cfg).numpy()
    assert_close(got, _gqa_oracle(q, k, v), rtol=1e-4, name="nondiv")


def test_decode_matches_train_row():
    """attention_decode at position p equals row p of the train path,
    and the reference's decode row."""
    cfg = dataclasses.replace(ATTN_CFG, attn_impl="xla")
    jcfg = dataclasses.replace(rget_smoke("qwen3-14b"), attn_impl="xla")
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, 8, cfg.d_model)) * .1).astype(np.float32)
    jp = JA.init_attention(jax.random.key(0), jcfg)
    p = {k: _t(v) for k, v in jp.items()}
    pos = torch.arange(8).expand(B, 8)
    want = TA.attention_train(p, cfg, _t(x), pos).numpy()
    ck = torch.zeros((B, 8, cfg.n_kv, cfg.d_head))
    cv = torch.zeros_like(ck)
    jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    outs, jouts = [], []
    for j in range(8):
        o, ck, cv = TA.attention_decode(p, cfg, _t(x[:, j:j + 1]), ck, cv,
                                        torch.full((B,), j))
        jo, jck, jcv = JA.attention_decode(jp, jcfg,
                                           jnp.asarray(x[:, j:j + 1]),
                                           jck, jcv,
                                           jnp.full((B,), j, jnp.int32))
        outs.append(o.numpy())
        jouts.append(np.asarray(jo))
    assert_close(np.concatenate(outs, 1), want, rtol=1e-3,
                 name="decode-vs-train")
    assert_close(np.concatenate(outs, 1), np.concatenate(jouts, 1),
                 rtol=1e-4, name="decode-vs-reference")
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), rtol=1e-5,
                               atol=1e-6)


# ---------------- the model ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch, dtype):
    """prefill on carried weights against ``T.prefill``: the xla impl and
    the flash impl (K20's plain version) both."""
    jcfg, jp, cfg, p = _pair(arch, dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    want = np.asarray(jax.jit(lambda p_, t: JT.prefill(
        p_, jcfg, {"tokens": t}))(jp, jnp.asarray(toks)))
    for impl in ("xla", "flash"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        got = TT.prefill(TT.cast_params(p, c), c, {"tokens": _t(toks)})
        assert got.shape == (B, cfg.vocab) and got.dtype == torch.float32
        _check(got.numpy(), want, dtype, f"{arch} {dtype} {impl}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(arch, dtype):
    """Eight decode steps at per-row positions (the rows one position
    apart) against ``D.decode_step``: logits each step and the caches."""
    jcfg, jp, cfg, p = _pair(arch, dtype, seed=1)
    toks = np.random.default_rng(2).integers(1, cfg.vocab, (B, 9))
    cache = TD.init_cache(cfg, B, 16, device="cpu")
    jc = JD.init_cache(jcfg, B, 16)
    jstep = jax.jit(lambda p_, c, t, q: JD.decode_step(p_, jcfg, c, t, q))
    for j in range(8):
        pos = np.array([j, j + 1])
        tl, cache = TD.decode_step(p, cfg, cache, _t(toks[:, j:j + 1]),
                                   _t(pos))
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, j:j + 1]),
                       jnp.asarray(pos, jnp.int32))
        _check(tl.numpy(), np.asarray(jl), dtype, f"{arch} step {j}")
    assert _rel(cache["k"].float().numpy(),
                np.asarray(jc["k"], np.float32)) < BF16_RTOL


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_decode_consistency(impl):
    """Token-by-token decode reproduces the parallel forward (the
    reference's test_prefill_decode_consistency, port against port)."""
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), attn_impl=impl)
    gen = torch.Generator()
    gen.manual_seed(1)
    p = TT.init_params(gen, cfg)
    toks = _t(np.random.default_rng(3).integers(1, cfg.vocab, (B, 8)))
    want = TT.prefill(p, cfg, {"tokens": toks}).numpy()
    cache = TD.init_cache(cfg, B, 8, device="cpu")
    for j in range(8):
        logits, cache = TD.decode_step(p, cfg, cache, toks[:, j:j + 1],
                                       torch.full((B,), j))
    got = logits.numpy()
    assert _rel(got, want) < BF16_RTOL
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.5


def test_flash_prefill_runs_the_kernel_path_per_layer(monkeypatch):
    """attn_impl="flash" reaches ops.flash_attention once a layer; "auto"
    at this S never does (it resolves to xla, as the reference's)."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), attn_impl="flash")
    gen = torch.Generator()
    gen.manual_seed(0)
    p = TT.init_params(gen, cfg)
    toks = torch.zeros((1, 16), dtype=torch.long)
    TT.prefill(p, cfg, {"tokens": toks})
    assert len(calls) == cfg.n_layers
    TT.prefill(p, dataclasses.replace(cfg, attn_impl="auto"),
               {"tokens": toks})
    assert len(calls) == cfg.n_layers
