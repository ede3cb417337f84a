"""K8's round-robin pair order on the CPU: the schedule, the plan, and
the plain version that runs a round's disjoint pairs at once, against
the JAX reference.

``jacobi_rounds`` is the one source of the pair order (the kernel
computes the same pairs by ``round_pair``'s formula).  The plain version
rotates other pairs in another order than the reference's cyclic one, so
it is held by sorted spectrum and reconstruction U diag(S) V^T at the
spec's rtol, 4 sqrt(eps_f32), against the reference's ``svd_pallas``
(interpret mode) and its oracle at even and odd n; and, port against
port, bit for bit where the order is the same: a lane alone and in a
batch, the identity and zero lanes.  The kernel's forms are held to one
set of bits on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``);
here the reduction they share is emulated in float32.
"""
import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.svd import svd_pallas  # noqa: E402
from repro.pipelines.pusch import svd_factor_pallas  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
tsvd = importlib.import_module("repro_torch.kernels.svd")

from conftest import assert_close  # noqa: E402

RTOL = RK.get("svd").rtol


# ---------------- the schedule ----------------

@pytest.mark.parametrize("n", range(2, 34))
def test_rounds_pair_every_column_pair_once_a_sweep(n):
    """n - 1 rounds for even n, n for odd; a round's pairs are disjoint,
    p < q < n (the phantom column of an odd n never rotates); every pair
    appears exactly once a sweep; for odd n column r sits out round r."""
    rounds = tsvd.jacobi_rounds(n)
    assert len(rounds) == (n if n % 2 else n - 1)
    seen = []
    for r, pairs in enumerate(rounds):
        assert len(pairs) == n // 2
        cols = [c for pair in pairs for c in pair]
        assert len(set(cols)) == len(cols), f"round {r} shares a column"
        assert all(0 <= p < q < n for p, q in pairs)
        if n % 2:
            assert set(range(n)) - set(cols) == {r}
        seen += pairs
    assert sorted(seen) == list(itertools.combinations(range(n), 2))


def test_round_pair_is_the_circle_ordering():
    """Pair 0 holds the fixed last column, pair i > 0 the columns i
    either side of r (mod cols - 1), lower index first."""
    assert tsvd.round_pair(8, 0, 0) == (0, 7)
    assert tsvd.round_pair(8, 3, 0) == (3, 7)
    assert tsvd.round_pair(8, 0, 1) == (1, 6)
    assert tsvd.round_pair(8, 2, 3) == (5, 6)
    assert tsvd.jacobi_rounds(1) == ((),)
    assert tsvd.jacobi_rounds(0) == ()


# ---------------- the plan ----------------

def _kernel_rounds(n):
    """The pairs csrc/svd.cu's groups take, by its recurrence: group g
    holds pair i = g + n % 2, starts at x = i, y = (i == 0 ? cols - 1 :
    cols - 1 - i) and advances both (x alone for pair 0) by one mod
    cols - 1 a round."""
    cols = n + n % 2
    c1 = cols - 1
    xy = [[i, c1 if i == 0 else c1 - i] for i in range(n % 2, cols // 2)]
    rounds = []
    for _ in range(c1):
        rounds.append(tuple((min(x, y), max(x, y)) for x, y in xy))
        for i, pair in zip(range(n % 2, cols // 2), xy):
            pair[0] = (pair[0] + 1) % c1
            if i:
                pair[1] = (pair[1] + 1) % c1
    return tuple(rounds)


@pytest.mark.parametrize("n", range(1, 34))
def test_kernel_recurrence_walks_jacobi_rounds(n):
    """The kernel's pairs, advanced a round at a time, are
    jacobi_rounds' in every round of two sweeps."""
    assert _kernel_rounds(n) == tsvd.jacobi_rounds(n)


# ---------------- the plan ----------------

@pytest.mark.parametrize("m,n", [(12, 8), (28, 24), (36, 32), (17, 13),
                                 (5, 1), (2, 2), (130, 100), (174, 170)])
def test_forms_fit_a_cta_and_the_plan_is_one_of_them(m, n):
    """Each group size whose CTA stays within its launch bound, its rows
    read again and, at m <= 64, held in registers (ceil(m / 32) blocks)."""
    forms = tsvd.svd_forms(m, n)
    assert forms and all(
        p.threads <= tsvd.SVD_MAX_THREADS[p.group] and p.threads % 32 == 0
        and p.threads >= (n // 2) * p.group for p in forms)
    groups = [g for g in tsvd.SVD_GROUPS
              if (n // 2) * g <= tsvd.SVD_MAX_THREADS[g]]
    caches = [0, -(-m // 32)] if m <= 64 else [0]
    assert forms == [tsvd.SvdPlan(g, tsvd.svd_threads(n, g), c)
                     for g in groups for c in caches]
    for batch in (1, 4, 32, 3276):
        assert tsvd.svd_plan(batch, m, n) in forms


def test_plan_off_its_forms_is_refused_on_every_device():
    a = torch.zeros((1, 12, 8))
    with pytest.raises(ValueError, match="not a form"):
        tsvd.svd_fused(a, 14, plan=tsvd.SvdPlan(64, 128, 0))
    with pytest.raises(ValueError, match="not a form"):
        tp.svd_factor_fused(a, plan=tsvd.SvdPlan(8, 64, 0))
    with pytest.raises(ValueError, match="not a form"):
        tsvd.svd_fused(a, 14, plan=tsvd.SvdPlan(8, 32, 2))
    ok = tsvd.svd_forms(12, 8)[0]
    assert torch.equal(tsvd.svd_fused(a, 14, plan=ok)[1],
                       tsvd.svd_fused(a, 14)[1])


def test_fit_recovers_the_round_model():
    """fit_round_ns returns the prices that made the rows, a form at a
    time (a lane alone on its SM its chain, lanes sharing one their issue
    a warp, each wave alike), and keeps a price it has no rows for."""
    want = {(g, c): {"chain": (800.0 + g, 30.0 - g / 2 + 5 * (not c)),
                     "issue": (20.0 + g, 3.0 - g / 16 + (not c))}
            for g in tsvd.SVD_GROUPS for c in (False, True)}
    rows = []
    for n, m, batch in ((24, 28, 32), (8, 12, 4), (32, 36, 3276),
                        (16, 20, 3276), (8, 12, 3276)):
        for plan in tsvd.svd_forms(m, n):
            price = want[plan.group, bool(plan.cache)]
            per_sm = tsvd.svd_lanes_an_sm(m, n, plan)
            k = min(per_sm, -(-batch // 132))
            waves = -(-batch // (132 * per_sm))
            a, b = price["chain" if k == 1 else "issue"]
            rows.append((n, m, batch, plan, waves * (a + b * (m + n)) * (
                1 if k == 1 else k * plan.threads / 32)))
    got = tsvd.fit_round_ns(rows)
    for form, price in want.items():
        for part in ("chain", "issue"):
            assert got[form][part] == pytest.approx(price[part]), (form, part)
    got = tsvd.fit_round_ns(rows[:1])
    assert got == tsvd.SVD_ROUND_NS


# ---------------- the reduction every form shares ----------------

def _butterfly(partials):
    """The xor butterfly over 32 float32 partials at offsets 16..1, each
    lane adding its partner's value to its own."""
    v = list(partials)
    for off in (16, 8, 4, 2, 1):
        v = [np.float32(v[k] + v[k ^ off]) for k in range(32)]
    return v


def _group_sum(partials, g):
    """What csrc/svd.cu group_sums does for groups of g threads: thread j
    holds partials j, j + g, ...; levels at offsets >= g in registers,
    the rest across the group's threads."""
    held = [[partials[j + t * g] for t in range(32 // g)] for j in range(g)]
    off = 16
    while off >= g:
        step = off // g
        for acc in held:
            for t in range(32 // g):
                if t & step == 0:
                    acc[t] = np.float32(acc[t] + acc[t + step])
        off //= 2
    v = [acc[0] for acc in held]
    off = g // 2
    while off:
        v = [np.float32(v[j] + v[j ^ off]) for j in range(g)]
        off //= 2
    return v


@pytest.mark.parametrize("g", tsvd.SVD_GROUPS)
def test_group_sums_give_the_butterflys_bits(g):
    """Every group size closes the 32 partials to the bits of the warp
    butterfly, on values of every scale and sign."""
    rng = np.random.default_rng(g)
    for _ in range(50):
        p = (rng.standard_normal(32)
             * 10.0 ** rng.integers(-8, 8, 32)).astype(np.float32)
        want = _butterfly(p)
        assert len(set(map(float, want))) == 1
        got = _group_sum(p, g)
        assert all(np.float32(x).tobytes() == want[0].tobytes()
                   for x in got)


# ---------------- the plain version against the reference ----------------

def _lanes(n, seed, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, n + 4, n)).astype(np.float32)


def _held(got, want, oracle_a, name):
    """Spectrum and reconstruction of ``got`` (u, s, v) against ``want``
    (u, s, v, numpy) and against the oracle's spectrum and A."""
    spec, recon = (x.numpy() for x in tsvd.spectrum_recon(*got))
    wu, ws, wv = want
    assert_close(spec, -np.sort(-ws, axis=-1), rtol=RTOL,
                 name=f"{name} spectrum vs pallas")
    assert_close(recon, np.einsum("bmn,bn,bkn->bmk", wu, ws, wv),
                 rtol=RTOL, name=f"{name} recon vs pallas")
    assert_close(spec, np.asarray(jref.svd_vals(jnp.asarray(oracle_a))),
                 rtol=RTOL, name=f"{name} spectrum vs oracle")
    assert_close(recon, oracle_a, rtol=RTOL, name=f"{name} recon vs oracle")


@pytest.mark.parametrize("n", [7, 8, 12, 13])
def test_plain_rounds_match_svd_pallas_and_oracle(n):
    """svd_fused on the CPU (the plain version, 12 sweeps of rounds)
    against the reference's svd_pallas (interpret mode, 12 cyclic
    sweeps) and the oracle."""
    a = _lanes(n, 600 + n)
    got = tsvd.svd_fused(torch.from_numpy(a), 12)
    want = [np.asarray(x) for x in svd_pallas(jnp.asarray(a), sweeps=12,
                                                interpret=True)]
    _held(got, want, a, f"svd n={n}")


@pytest.mark.parametrize("n", [7, 8, 12, 13])
def test_plain_svd_factor_matches_the_reference_stage(n):
    """The DAG's svd_factor stage on the CPU (14 sweeps of rounds,
    packed [U; V; s]) against the reference's svd_factor_pallas
    (interpret mode) and the oracle."""
    a = _lanes(n, 700 + n)
    m = n + 4
    f = tp.svd_factor_fused(torch.from_numpy(a))
    assert f.shape == (2, m + n + 1, n)
    jf = np.asarray(svd_factor_pallas(jnp.asarray(a), interpret=True))
    _held(tp.unpack_factors(f), (jf[:, :m], jf[:, m + n], jf[:, m:m + n]),
          a, f"svd_factor n={n}")


# ---------------- port against port ----------------

@pytest.mark.parametrize("n", [7, 8, 13])
def test_lane_alone_gives_its_bits_in_a_batch(n):
    """A lane's U, S and V are the same bits alone and as lane 3 of 5, by
    svd_fused and by the DAG stage."""
    a = torch.from_numpy(_lanes(n, 800 + n, b=5))
    full = tsvd.svd_fused(a, 14)
    alone = tsvd.svd_fused(a[3:4].contiguous(), 14)
    for x, y in zip(full, alone):
        assert torch.equal(x[3:4], y)
    f = tp.svd_factor_fused(a)
    assert torch.equal(f[3:4], tp.svd_factor_fused(a[3:4].contiguous()))
    for x, y in zip(tp.unpack_factors(f), full):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [8, 12, 13])
def test_identity_lane_gives_unit_spectrum_and_identity_v(n):
    """The svd_factor filler np.eye(m, n): every pair is orthogonal, so
    every rotation is the identity; s = 1, V = I and U = A exactly."""
    m = n + 4
    a = torch.from_numpy(np.eye(m, n, dtype=np.float32))[None]
    u, s, v = tsvd.svd_fused(a, 14)
    assert torch.equal(s, torch.ones((1, n)))
    assert torch.equal(v, torch.eye(n)[None])
    assert torch.equal(u, a)


def test_zero_lane_exact_and_rank_two_lane_finite():
    """An all-zero lane gives s = 0, U = 0 and V = I exactly; a rank-2
    lane stays finite, with two singular values above 1e-3 of the
    largest, and rebuilds A."""
    rng = np.random.default_rng(11)
    low = rng.standard_normal((13 + 4, 2)) @ rng.standard_normal((2, 13))
    a = torch.from_numpy(np.stack([np.zeros((17, 13)), low]).astype(
        np.float32))
    u, s, v = tsvd.svd_fused(a, 14)
    assert torch.equal(s[0], torch.zeros(13))
    assert torch.equal(u[0], torch.zeros((17, 13)))
    assert torch.equal(v[0], torch.eye(13))
    assert all(bool(torch.isfinite(t[1]).all()) for t in (u, s, v))
    assert int((s[1] > 1e-3 * s[1].max()).sum()) == 2
    recon = tsvd.spectrum_recon(u[1:], s[1:], v[1:])[1]
    assert_close(recon.numpy(), a[1:].numpy(), rtol=RTOL,
                 name="rank-2 reconstruction")
