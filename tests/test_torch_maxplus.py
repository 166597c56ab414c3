"""Port parity for the max-plus FIFO solvers (`repro_torch.fleet.maxplus`)
on the CPU: tests/test_fleet_properties.py run on the port's solvers
against the oracles.

- `fifo_done_maxplus` vs `fifo_oracle` (single-server FIFO), and
- `kserver_done_maxplus` vs `kserver_oracle` (shared cloud tier,
  constant service so the residue-class decomposition is exact),

across >= 200 generated examples plus the eight explicit edge cases. The
reference's own solvers cannot run here (`jax.experimental.enable_x64` is
gone from the installed JAX, ROADMAP caveat a), so the port is held to
the oracles, to the reference's oracles and to the host `fifo_done` of
both packages instead.

Tolerances: on dyadic-rational inputs (small integers scaled by a power
of two) float addition is exact, so the closed form and the sequential
oracle must agree bit for bit; general float inputs agree to rel 1e-12 /
abs 1e-12, which only absorbs re-association round-off.

The generated sweep runs under `hypothesis` when it is installed
(derandomized, so a run replays the same examples) and falls back to an
equivalent seeded numpy sweep otherwise.
"""
import numpy as np
import pytest
import torch

from repro.fleet import maxplus as jmaxplus
from repro.fleet.simulator import fifo_done as jfifo_done
from repro_torch.fleet import maxplus
from repro_torch.fleet.maxplus import fifo_oracle, kserver_oracle
from repro_torch.fleet.simulator import fifo_done

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # no dev extras: seeded sweep below
    HAVE_HYPOTHESIS = False

N_EXAMPLES = 200
RTOL = dict(rtol=1e-12, atol=1e-12)


def fifo_done_maxplus(t, service, free_s=0.0):
    return maxplus.fifo_done_maxplus(t, service, free_s, device="cpu")


def kserver_done_maxplus(t, service, k):
    return maxplus.kserver_done_maxplus(t, service, k, device="cpu")


# ---------------------------------------------------------------- helpers
def dyadic_case(rng, n):
    """Arrival/service columns whose float sums are exact."""
    t = rng.integers(0, 512, n).astype(np.float64) * 2.0**-6
    s = rng.integers(0, 64, n).astype(np.float64) * 2.0**-6
    return t, s


def float_case(rng, n):
    t = rng.uniform(0.0, 30.0, n)
    s = rng.uniform(0.0, 2.0, n)
    return t, s


def assert_fifo_matches(t, s, free=0.0, exact=False):
    got = fifo_done_maxplus(t, s, free)
    want = fifo_oracle(t, s, free)
    assert got.dtype == np.float64
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **RTOL)


# ------------------------------------------------- generated example sweep
if HAVE_HYPOTHESIS:

    @settings(max_examples=N_EXAMPLES, deadline=None, derandomize=True, database=None)
    @given(
        data=st.lists(st.tuples(st.integers(0, 512), st.integers(0, 64)),
                      min_size=1, max_size=128),
        free=st.integers(0, 256),
    )
    def test_fifo_scan_matches_oracle_exactly(data, free):
        """Dyadic inputs: closed form == sequential oracle, bit for bit."""
        arr = np.asarray(data, dtype=np.float64) * 2.0**-6
        assert_fifo_matches(arr[:, 0], arr[:, 1], free=float(free) * 2.0**-6, exact=True)

    @settings(max_examples=N_EXAMPLES, deadline=None, derandomize=True, database=None)
    @given(seed=st.integers(0, 2**32 - 1), n=st.integers(1, 200))
    def test_fifo_scan_matches_oracle_floats(seed, n):
        """General float inputs: equal to re-association round-off."""
        rng = np.random.default_rng(seed)
        t, s = float_case(rng, n)
        assert_fifo_matches(t, s, free=rng.uniform(0.0, 5.0))

    @settings(max_examples=N_EXAMPLES, deadline=None, derandomize=True, database=None)
    @given(seed=st.integers(0, 2**32 - 1), n=st.integers(1, 150), k=st.integers(1, 8))
    def test_kserver_scan_matches_oracle(seed, n, k):
        """Constant-service K-server: residue chains == earliest-free."""
        rng = np.random.default_rng(seed)
        t, _ = dyadic_case(rng, n)
        t.sort()  # cloud jobs arrive in completion order
        s = np.full(n, rng.integers(1, 64) * 2.0**-6)
        np.testing.assert_array_equal(kserver_done_maxplus(t, s, k), kserver_oracle(t, s, k))

else:

    def test_fifo_scan_matches_oracle_exactly():
        rng = np.random.default_rng(0)
        for _ in range(N_EXAMPLES):
            n = int(rng.integers(1, 129))
            t, s = dyadic_case(rng, n)
            assert_fifo_matches(t, s, free=float(rng.integers(0, 256)) * 2.0**-6, exact=True)

    def test_fifo_scan_matches_oracle_floats():
        rng = np.random.default_rng(1)
        for _ in range(N_EXAMPLES):
            n = int(rng.integers(1, 201))
            t, s = float_case(rng, n)
            assert_fifo_matches(t, s, free=rng.uniform(0.0, 5.0))

    def test_kserver_scan_matches_oracle():
        rng = np.random.default_rng(2)
        for _ in range(N_EXAMPLES):
            n = int(rng.integers(1, 151))
            k = int(rng.integers(1, 9))
            t, _ = dyadic_case(rng, n)
            t.sort()
            s = np.full(n, rng.integers(1, 64) * 2.0**-6)
            np.testing.assert_array_equal(kserver_done_maxplus(t, s, k),
                                          kserver_oracle(t, s, k))


# ----------------------------------------------------- explicit edge cases
def test_empty_window():
    out = fifo_done_maxplus(np.empty(0), np.empty(0))
    assert out.shape == (0,) and out.dtype == np.float64


def test_single_request():
    np.testing.assert_array_equal(fifo_done_maxplus(np.array([3.0]), np.array([0.5])), [3.5])
    np.testing.assert_array_equal(  # busy server delays the lone arrival
        fifo_done_maxplus(np.array([1.0]), np.array([0.5]), free_s=4.0), [4.5])


def test_zero_service_requests():
    """s == 0 jobs complete at max(arrival, predecessor-done) exactly."""
    t = np.array([0.0, 1.0, 1.0, 2.0, 5.0])
    s = np.zeros(5)
    assert_fifo_matches(t, s, exact=True)
    np.testing.assert_array_equal(fifo_done_maxplus(t, s), t)
    s2 = np.array([2.0, 0.0, 0.5, 0.0, 0.0])
    assert_fifo_matches(t, s2, exact=True)


def test_arrival_ties():
    """Simultaneous arrivals queue in column order, deterministically."""
    t = np.full(16, 2.5)
    s = np.full(16, 0.25)
    np.testing.assert_array_equal(fifo_done_maxplus(t, s), 2.5 + 0.25 * np.arange(1, 17))
    assert_fifo_matches(t, s, exact=True)


def test_saturated_queue():
    """All work arrives at t=0: done times are the pure service cumsum."""
    rng = np.random.default_rng(7)
    s = rng.integers(1, 32, 100).astype(np.float64) * 2.0**-4
    t = np.zeros(100)
    np.testing.assert_array_equal(fifo_done_maxplus(t, s), np.cumsum(s))
    assert_fifo_matches(t, s, exact=True)


def test_unsorted_arrivals():
    """The max-plus form never assumes sorted t; the oracle is the spec."""
    rng = np.random.default_rng(11)
    t, s = dyadic_case(rng, 64)
    rng.shuffle(t)
    assert_fifo_matches(t, s, exact=True)


def test_busy_server_free_time():
    t = np.array([0.0, 0.5, 4.0])
    s = np.array([1.0, 1.0, 1.0])
    np.testing.assert_array_equal(fifo_done_maxplus(t, s, free_s=10.0), [11.0, 12.0, 13.0])


def test_kserver_edges():
    # k >= n: every job gets its own server
    t = np.array([0.0, 0.0, 1.0])
    s = np.full(3, 2.0)
    np.testing.assert_array_equal(kserver_done_maxplus(t, s, 5), [2.0, 2.0, 3.0])
    # k == 1 degenerates to plain FIFO
    rng = np.random.default_rng(13)
    td, sd = dyadic_case(rng, 40)
    td.sort()
    sc = np.full(40, sd[0])
    np.testing.assert_array_equal(kserver_done_maxplus(td, sc, 1), fifo_done_maxplus(td, sc))
    # empty
    assert kserver_done_maxplus(np.empty(0), np.empty(0), 3).shape == (0,)


# ------------------------------------------------------ beyond the reference
def test_oracles_equal_reference_oracles():
    """The port's own copies of the oracles are the reference's, value for
    value, on unsorted float inputs."""
    rng = np.random.default_rng(3)
    t, s = float_case(rng, 300)
    np.testing.assert_array_equal(fifo_oracle(t, s, 1.5), jmaxplus.fifo_oracle(t, s, 1.5))
    ts = np.sort(t)
    for k in (1, 3, 4):
        np.testing.assert_array_equal(kserver_oracle(ts, s, k),
                                      jmaxplus.kserver_oracle(ts, s, k))


def test_long_chain_matches_host_fifo_done():
    """A 65 536-request chain of general floats: the closed form equals
    both packages' host `fifo_done` (sequential cumsum + running max) to
    rel 1e-12, and the K-server solve at a dyadic service time (exact
    running sums) equals one host chain per residue class bit for bit."""
    rng = np.random.default_rng(5)
    n = 1 << 16
    t = np.cumsum(rng.exponential(0.02, n))
    s = rng.uniform(0.005, 0.03, n)
    host = fifo_done(t, s, 0.25)
    np.testing.assert_array_equal(host, jfifo_done(t, s, 0.25))
    np.testing.assert_allclose(fifo_done_maxplus(t, s, 0.25), host, rtol=1e-12, atol=0)
    cloud = np.full(n, 9 * 2.0**-7)
    want = np.empty(n)
    for r in range(4):
        want[r::4] = fifo_done(t[r::4], cloud[r::4], 0.0)
    np.testing.assert_array_equal(kserver_done_maxplus(t, cloud, 4), want)


def test_masked_columns_are_independent_chains():
    """`maxplus_fifo` on a (rows, chains) layout: each column is its own
    chain with its own free time, and masked rows pass through as the
    semiring identity (the layout the K-server solve and the compiled
    fleet use)."""
    rng = np.random.default_rng(9)
    t, s = dyadic_case(rng, 24)
    t2, s2 = t.reshape(8, 3), s.reshape(8, 3)
    mask = np.ones((8, 3), bool)
    mask[5:, 2] = False  # a short last chain
    mask[2, 1] = False  # a hole: the row is skipped
    free = np.array([0.0, 1.5, 40.0])
    got = maxplus.maxplus_fifo(torch.as_tensor(t2), torch.as_tensor(s2),
                               torch.as_tensor(mask), torch.as_tensor(free)).numpy()
    assert got.dtype == np.float64
    for c in range(3):
        m = mask[:, c]
        np.testing.assert_array_equal(got[m, c], fifo_oracle(t2[m, c], s2[m, c], free[c]))


@pytest.mark.parametrize("shape", [(1,), (1023,), (1024,), (1025,), (5000,), (3000, 3),
                                   (2049, 1)])
def test_maxplus_fifo_columns_equal_oracle(shape):
    """`maxplus_fifo` on 1-D chains and (rows, chains) layouts of many
    lengths, with a free time per chain and about a tenth of the rows
    masked out: every column's unmasked rows equal the per-request oracle
    exactly on dyadic inputs."""
    rng = np.random.default_rng(len(shape) * 10_000 + shape[0])
    t = rng.integers(0, 512, shape) * 2.0**-6
    s = rng.integers(0, 64, shape) * 2.0**-6
    mask = rng.random(shape) >= 0.1
    free = rng.integers(0, 256, shape[1:]) * 2.0**-6
    got = maxplus.maxplus_fifo(torch.as_tensor(t), torch.as_tensor(s), torch.as_tensor(mask),
                               torch.as_tensor(free)).numpy()
    assert got.shape == shape and got.dtype == np.float64
    cols = [(slice(None),)] if len(shape) == 1 else [(slice(None), c) for c in range(shape[1])]
    for col in cols:
        m = mask[col]
        np.testing.assert_array_equal(got[col][m],
                                      fifo_oracle(t[col][m], s[col][m], float(free[col[1:]])))
