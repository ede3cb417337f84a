"""The port's hybrid (zamba2: Mamba2 layers + a shared attention block) and
xLSTM (mLSTM + sLSTM) families against the JAX reference: parameters
carried across, ``prefill`` and ``decode_step`` on the smoke configs, the
port's own prefill <-> decode consistency, and continuous-batching
serving with slot reuse.

Tolerances, each a relative error ``max|got - want| / max|want|`` of the
logits:

* float32 compute: 1e-4 — the two frameworks' float32 products and
  transcendental functions differ in summation order and the last bits;
* bfloat16 compute (the configs' own): the port's bf16 logits lie within
  5e-2 of the reference's float32 logits — the reference's rule for bf16
  paths that round at different places (``tests/test_models.py::
  test_prefill_decode_consistency``) — or, where the reference's own bf16
  logits lie further than 2.5e-2 from its float32 ones, within twice
  that distance; and the argmax agrees with the reference's bf16 logits
  on at least half the rows.  The two bf16 computations round at other
  places (``jax.nn.silu`` rounds its sigmoid's every step, ``F.silu``
  once; the reference's models scan in ``backend="xla"``, whose bf16 path
  takes the log and cumsum of a bf16 decay, while K21 computes in float32
  as the reference's kernel does), so each is held to the float32 truth:
  on the zamba2 smoke config the two packages' bf16 logits lie a few per
  cent from their float32 ones, about as far from each other, so a
  direct 5e-2 between the two bf16 answers would leave no room for
  either package's own rounding.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import get_smoke as rget_smoke  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.decode import DecodeEngine as RDecodeEngine  # noqa: E402
from repro.serve.decode import Request as RRequest  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.decode import DecodeEngine, Request  # noqa: E402

ARCHS = ["zamba2-2.7b", "xlstm-125m"]
F32_RTOL = 1e-4
BF16_RTOL = 5e-2
B, S = 2, 32


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


def _check(got, want, dtype, name, want_f32=None):
    """``want`` is the reference's answer at ``dtype``; in bfloat16
    ``want_f32`` is its float32 answer on the same weights."""
    if dtype == "float32":
        rel = _rel(got, want)
        assert rel < F32_RTOL, f"{name}: rel err {rel:.3e}"
        return
    rel = _rel(got, want_f32)
    limit = max(BF16_RTOL, 2 * _rel(want, want_f32))
    assert rel < limit, f"{name}: rel err {rel:.3e} to float32 (< {limit})"
    agree = (np.asarray(got).argmax(-1) == np.asarray(want).argmax(-1))
    assert agree.mean() >= 0.5, f"{name}: argmax {agree}"


@functools.lru_cache(maxsize=None)
def _ref_params(arch, seed):
    """The reference's float32 parameters of ``arch``'s smoke config from
    key ``seed`` (the compute dtype does not enter the init)."""
    init = jax.jit(JT.init_params, static_argnums=1)
    return init(jax.random.key(seed), rget_smoke(arch))


def _pair(arch, dtype, seed=0):
    """(reference cfg, params) and (port cfg, params) of ``arch``'s smoke
    config at compute ``dtype``, the port's carried across."""
    jcfg = dataclasses.replace(rget_smoke(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=dtype)
    jp = _ref_params(arch, seed)
    p = TT.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")
    return jcfg, jp, cfg, p


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_maps_every_layer(arch):
    """The reference's stacked arrays land in the port's per-layer dicts
    value for value (the hybrid's shared block whole, the xLSTM's two
    stacks apart), the port's own init builds the same tree of shapes,
    and cast_params keeps the vectors float32."""
    jcfg, jp, cfg, p = _pair(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    stacks = {"": (tree["layers"], p["layers"])} if arch == "zamba2-2.7b" \
        else {k: (tree["layers"][k], p["layers"][k]) for k in ("m", "s")}
    for stacked, layers in stacks.values():
        for i, lp in enumerate(layers):
            for name, w in lp.items():
                np.testing.assert_array_equal(w.numpy(), stacked[name][i])
        assert len(layers) == len(next(iter(stacked.values())))
    if arch == "zamba2-2.7b":
        assert len(p["layers"]) == cfg.n_layers
        np.testing.assert_array_equal(p["shared"]["attn"]["wq"].numpy(),
                                      tree["shared"]["attn"]["wq"])
    gen = torch.Generator()
    gen.manual_seed(0)
    assert _shapes(TT.init_params(gen, cfg)) == _shapes(p)
    c = TT.cast_params(p, cfg)
    lp = c["layers"][0] if arch == "zamba2-2.7b" else c["layers"]["m"][0]
    for name, w in lp.items():
        assert w.dtype == (torch.bfloat16 if w.dim() >= 2
                           else torch.float32), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    """prefill on carried weights against ``T.prefill`` (the hybrid with
    its attention both as xla and as the flash kernel's plain
    version)."""
    jcfg, jp, cfg, p = _pair(arch, dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    want, want_f32 = (np.asarray(jax.jit(lambda p_, t: JT.prefill(
        p_, c, {"tokens": t}))(jp, jnp.asarray(toks)))
        for c in (jcfg, dataclasses.replace(jcfg, compute_dtype="float32")))
    impls = ("xla", "flash") if arch == "zamba2-2.7b" else ("auto",)
    for impl in impls:
        c = dataclasses.replace(cfg, attn_impl=impl)
        got = TT.prefill(TT.cast_params(p, c), c, {"tokens": _t(toks)})
        assert got.shape == (B, cfg.vocab) and got.dtype == torch.float32
        _check(got.numpy(), want, dtype, f"{arch} {dtype} {impl}",
               want_f32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype):
    """Six decode steps at per-row positions against ``D.decode_step``:
    the logits each step and the recurrent states after them."""
    jcfg, jp, cfg, p = _pair(arch, dtype, seed=1)
    toks = np.random.default_rng(2).integers(1, cfg.vocab, (B, 7))
    cache = TD.init_cache(cfg, B, 16, device="cpu")
    jcfg32 = dataclasses.replace(jcfg, compute_dtype="float32")
    jc, jc32 = JD.init_cache(jcfg, B, 16), JD.init_cache(jcfg32, B, 16)
    jstep = jax.jit(lambda p_, c, t, q: JD.decode_step(p_, jcfg, c, t, q))
    jstep32 = jax.jit(lambda p_, c, t, q: JD.decode_step(p_, jcfg32, c, t,
                                                         q))
    cp = TT.cast_params(p, cfg)
    for j in range(6):
        pos = np.array([j, j + 1])
        tok = jnp.asarray(toks[:, j:j + 1])
        tl, cache = TD.decode_step(cp, cfg, cache, _t(toks[:, j:j + 1]),
                                   _t(pos))
        jl, jc = jstep(jp, jc, tok, jnp.asarray(pos, jnp.int32))
        jl32, jc32 = jstep32(jp, jc32, tok, jnp.asarray(pos, jnp.int32))
        _check(tl.numpy(), np.asarray(jl), dtype, f"{arch} step {j}",
               np.asarray(jl32))
    state = ("state", "conv") if arch == "zamba2-2.7b" else ("m",)
    pairs = [(cache[k], jc[k], jc32[k]) for k in state]
    if arch == "xlstm-125m":
        pairs += [(cache["s"][k], jc["s"][k], jc32["s"][k])
                  for k in ("h", "c", "n")]
    for got, want, want32 in pairs:
        assert got.dtype == torch.float32
        got, want, want32 = (np.asarray(t, np.float32)
                             for t in (got, want, want32))
        if dtype == "float32":
            assert _rel(got, want) < F32_RTOL
        else:
            assert _rel(got, want32) < max(BF16_RTOL,
                                           2 * _rel(want, want32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Token-by-token decode reproduces the parallel forward (the
    reference's test_prefill_decode_consistency, port against port, at
    its seeds and its bf16 rule)."""
    cfg = get_smoke(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slots_gives_a_fresh_slots_state(arch):
    """reset_slots writes init_cache's values into the rows given and
    leaves the other rows (and any K/V) alone."""
    cfg = get_smoke(arch)
    fresh = TD.init_cache(cfg, 3, 8, device="cpu")
    cache = TD.init_cache(cfg, 3, 8, device="cpu")
    leaves = lambda c: [v for k, v in sorted(c.items()) if k != "s"] \
        + [v for _, v in sorted(c.get("s", {}).items())]
    for v in leaves(cache):
        v.fill_(3.0)
    TD.reset_slots(cfg, cache, [0, 2])
    for k, (got, want) in enumerate(zip(leaves(cache), leaves(fresh))):
        if got.shape[2:3] == (8,):                    # K/V: untouched
            assert torch.all(got == 3.0)
            continue
        assert torch.equal(got[:, [0, 2]], want[:, [0, 2]]), k
        assert torch.all(got[:, 1] == 3.0), k


def _engine(arch, batch=2, dtype=None):
    cfg = get_smoke(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    gen = torch.Generator()
    gen.manual_seed(0)
    return DecodeEngine(cfg, TT.init_params(gen, cfg), batch=batch,
                        max_len=64, eos_id=-1, device="cpu")


PROMPTS = [[5, 9, 2, 7], [11, 3], [8, 8, 1, 4, 6, 2, 9], [2, 30, 40],
           [17, 5, 5, 21, 3, 6]]


def _solo(engine, prompt, max_new=4):
    r = engine.submit(Request(prompt=list(prompt), max_new=max_new))
    engine.run()
    return r.out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_reuses_slots_and_matches_served_alone(arch):
    """Pool 2, five requests: slots are reused three times, and each
    greedy output equals the same request served alone."""
    engine = _engine(arch)
    reqs = [engine.submit(Request(prompt=list(p), max_new=4))
            for p in PROMPTS]
    engine.run()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert engine.metrics().decode.slot_reuses == 3
    assert [r.out for r in reqs] == [_solo(engine, p) for p in PROMPTS]


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_matters_for_reused_and_idle_slots(arch, monkeypatch):
    """Without reset_slots a reused slot carries its last request's
    recurrent state (the reference engine's behaviour), and so does a
    slot that idled through pool steps before its first request: both
    outputs then differ from the request served alone."""
    engine = _engine(arch)
    solo = [_solo(engine, p) for p in PROMPTS]

    def staggered(engine):
        """PROMPTS[0] alone for three steps (slot 1 idles), then the
        rest: slot 1 takes its first request after idling, then slots
        are reused."""
        first = engine.submit(Request(prompt=list(PROMPTS[0]), max_new=4))
        for _ in range(3):
            engine.step()
        rest = [engine.submit(Request(prompt=list(p), max_new=4))
                for p in PROMPTS[1:]]
        engine.run()
        return [r.out for r in [first] + rest]

    assert staggered(_engine(arch)) == solo
    monkeypatch.setattr(TD, "reset_slots", lambda cfg, cache, slots: cache)
    assert staggered(_engine(arch)) != solo


@pytest.mark.parametrize("arch", ARCHS)
def test_fresh_slots_equal_the_reference_engine(arch):
    """Float32, two requests into a fresh pool of two: the port's engine
    and the reference's (on the same weights) decode the same tokens."""
    jcfg, jp, cfg, p = _pair(arch, "float32")
    prompts = PROMPTS[:2]
    ref = RDecodeEngine(jcfg, jp, batch=2, max_len=32, eos_id=-1)
    rr = [ref.submit(RRequest(prompt=list(q), max_new=5)) for q in prompts]
    ref.run()
    mine = DecodeEngine(cfg, p, batch=2, max_len=32, eos_id=-1,
                        device="cpu")
    tr = [mine.submit(Request(prompt=list(q), max_new=5)) for q in prompts]
    mine.run()
    assert [r.out for r in tr] == [list(map(int, r.out)) for r in rr]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_the_family(arch, capsys):
    """``launch.serve --arch`` on the CPU: pool 2, five requests, each
    output the same served again alone on the launcher's weights."""
    out = TLS.main(["--device", "cpu", "--arch", arch, "--pool", "2",
                    "--requests", "5", "--max-new", "3"])
    assert out["done"] == 5 and out["tokens"] == 15
    cfg = get_smoke(arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    engine = DecodeEngine(cfg, TT.init_params(gen, cfg), batch=2,
                          max_len=128, eos_id=-1, device="cpu")
    assert [TLS.serve(engine, [q], 3)[0].out
            for q in out["prompts"]] == out["outputs"]
    assert cfg.name in capsys.readouterr().out


def test_chip_smoke_matrix_counts_equal_the_reference_tree():
    """``chip_smoke.matrix_count``, which the card run holds each
    full-width model's matrix parameters to, is the matrix count of the
    reference's ``init_params`` tree (its stacked layer arrays counted
    per layer): the config's ``param_count`` for phi4-mini and zamba2,
    the shapes' own sum for xLSTM, whose config count is rough."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for arch in ("phi4-mini-3.8b", "zamba2-2.7b", "xlstm-125m"):
        jcfg = rget_config(arch)
        tree = jax.eval_shape(lambda: JT.init_params(jax.random.key(0),
                                                     jcfg))
        count = 0
        for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            per_layer = leaf.ndim - (keys[0].key == "layers")
            if per_layer >= 2:
                count += int(np.prod(leaf.shape))
        assert smoke.matrix_count(get_config(arch)) == count, arch
    assert smoke.matrix_count(get_config("xlstm-125m")) \
        != get_config("xlstm-125m").param_count()


@pytest.mark.parametrize("arch", ARCHS + ["phi4-mini-3.8b"])
def test_reused_cache_row_keeps_the_reference_state(arch):
    """The reference's engine reuses a slot by resetting its position only:
    on its decode cache, request Y fed after a 6-token request X gives
    other last logits than Y fed into a fresh cache for the recurrent
    families (their state ignores the position), the same ones for the
    dense family (its stale K/V is masked).  The port's reset_slots gives
    the fresh cache's logits in every family."""
    jcfg = dataclasses.replace(rget_smoke(arch), compute_dtype="float32")
    jp = _ref_params(arch, 0)
    step = jax.jit(lambda c, t, q: JD.decode_step(jp, jcfg, c, t, q))
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    p = TT.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")

    def feed(cache, toks, port=False):
        for j, t in enumerate(toks):
            if port:
                logits, cache = TD.decode_step(
                    p, cfg, cache, torch.tensor([[t]]), torch.tensor([j]))
            else:
                logits, cache = step(cache, jnp.asarray([[t]]),
                                     jnp.asarray([j], jnp.int32))
        return np.asarray(logits), cache

    x_toks, y_toks = [5, 9, 2, 7, 11, 3], [8, 8, 1, 4]
    _, used = feed(JD.init_cache(jcfg, 1, 16), x_toks)
    reused, _ = feed(used, y_toks)
    fresh, _ = feed(JD.init_cache(jcfg, 1, 16), y_toks)
    diff = float(np.max(np.abs(reused - fresh)))
    assert (diff > 1e-3) if arch in ARCHS else diff == 0.0, diff
    _, used = feed(TD.init_cache(cfg, 1, 16, device="cpu"), x_toks, True)
    reset, _ = feed(TD.reset_slots(cfg, used, [0]), y_toks, True)
    assert np.allclose(reset, fresh, rtol=0, atol=1e-4 * np.abs(fresh).max())
