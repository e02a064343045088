"""The port's open-loop engine (`repro_torch.sim.simulate`, on the CPU
through the kernels' plain versions) against the live reference
(`repro.sim.simulate`, kernel_path="ref"):

- `make_traffic`: active sets equal, destinations equal under replayed
  draws;
- `simulate` under `ReplaySource` fed the reference's own draws (its
  key schedule, `jax.random`): every `SimResult` field and per-cycle
  array EQUAL, for min/val/ugal_l/ugal_g on uniform/shift/bitrev/
  worstcase_sf, healthy and failure-masked, plus a stale-table run;
- with the native source (`TorchSource`), the SF cases of
  tests/test_sim.py: conservation at every cycle, low-load latency,
  the Fig 6 orderings of the routing modes, determinism given a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.sim import SimConfig as JaxSimConfig
from repro.sim import make_traffic as jax_make_traffic
from repro.sim import simulate as jax_simulate
from repro_torch.sim import (Draw, ReplaySource, SimConfig, TorchSource,
                             make_traffic, simulate)
from test_torch_ugal import both_tables, one_torch_thread  # noqa: F401


# the raw draw each pattern takes from the `dst` stream, and each mode
# from the `route` stream (None: no draw)
DST_DRAW = {"uniform": "randint", "worstcase_df": "randint",
            "shift": "bernoulli"}
ROUTE_DRAW = {"val": "one", "ugal_l": "cands", "ugal_g": "cands"}


def dst_high(tables, pattern):
    """Upper bound of a pattern's raw randint draw: uniform draws on
    [0, n_ep - 1) (then skips the source's own id), worstcase_df the
    offset in the next group on [0, a * p)."""
    if pattern == "worstcase_df":
        return tables.topo.params["a"] * tables.p
    return tables.n_endpoints - 1


def open_loop_draws(seed, cycles, rate, n_ep, N, C, pattern, mode,
                    high=None):
    """The reference's open-loop draws: per cycle
    `key, k_inj, k_dst, k_rt = split(key, 4)` (src/repro/sim/engine.py),
    then the injection coins, the pattern's raw destination draw (a
    randint on [0, high), default uniform's n_ep - 1) and the mode's
    route draw, recorded for a `ReplaySource`."""
    dst_kind, rt_kind = DST_DRAW.get(pattern), ROUTE_DRAW.get(mode)
    rt_shape = (n_ep,) if rt_kind == "one" else (n_ep, C)
    high = n_ep - 1 if high is None else high

    def step(rate32, key, _):
        key, k_inj, k_dst, k_rt = jax.random.split(key, 4)
        coin = jax.random.bernoulli(k_inj, rate32, (n_ep,))
        if dst_kind == "randint":
            dst = jax.random.randint(k_dst, (n_ep,), 0, high)
        elif dst_kind == "bernoulli":
            dst = jax.random.bernoulli(k_dst, 0.5, (n_ep,))
        else:
            dst = jnp.zeros((), jnp.int32)
        rt = (jax.random.randint(k_rt, rt_shape, 0, N) if rt_kind
              else jnp.zeros((), jnp.int32))
        return key, (coin, dst, rt)

    run = jax.jit(lambda r, k: jax.lax.scan(
        lambda key, x: step(r, key, x), k, None, length=cycles))
    _, (coin, dst, rt) = run(jnp.float32(rate), jax.random.PRNGKey(seed))
    coin, dst, rt = map(np.asarray, (coin, dst, rt))
    draws = {}
    for c in range(cycles):
        draws[(c, "inj")] = Draw("bernoulli", rate, coin[c])
        if dst_kind == "randint":
            draws[(c, "dst")] = Draw("randint", (0, high), dst[c])
        elif dst_kind == "bernoulli":
            draws[(c, "dst")] = Draw("bernoulli", 0.5, dst[c])
        if rt_kind:
            draws[(c, "route")] = Draw("randint", (0, N), rt[c])
    return draws


SCALARS = ("name", "offered_load", "accepted_load", "avg_latency",
           "delivered", "injected", "dropped_at_source", "src_occupancy",
           "q_src", "saturated")
ARRAYS = ("per_cycle_delivered", "per_cycle_injected", "per_cycle_in_flight",
          "per_cycle_dropped")


def assert_results_equal(port, ref):
    for f in SCALARS:
        assert getattr(port, f) == getattr(ref, f), f
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)


def run_both(q, kind, pattern, mode, **kw):
    return run_both_on(*both_tables(q, kind), pattern, mode, **kw)


def run_both_on(jt, tt, pattern, mode, **kw):
    """The reference's run and the port's, fed the reference's draws, on
    tables `jt` and `tt` of one fabric."""
    cfg = dict(injection_rate=0.4, cycles=100, warmup=30, mode=mode, seed=5)
    cfg.update(kw)
    ref = jax_simulate(jt, jax_make_traffic(jt, pattern),
                       JaxSimConfig(kernel_path="ref", **cfg))
    src = ReplaySource(open_loop_draws(
        cfg["seed"], cfg["cycles"], cfg["injection_rate"], tt.n_endpoints,
        tt.n_routers, 4, pattern, mode, high=dst_high(tt, pattern)))
    port = simulate(tt, make_traffic(tt, pattern), SimConfig(**cfg),
                    device="cpu", source=src)
    return port, ref


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,seed", [
    ("uniform", 0), ("shuffle", 0), ("bitrev", 0), ("bitcomp", 0),
    ("shift", 0), ("worstcase_sf", 0), ("worstcase_sf", 3)])
@pytest.mark.parametrize("kind", ["healthy", "masked"])
def test_make_traffic_matches_reference(pattern, seed, kind):
    jt, tt = both_tables(5, kind)
    ref = jax_make_traffic(jt, pattern, seed=seed)
    port = make_traffic(tt, pattern, seed=seed)
    assert port.name == ref.name
    np.testing.assert_array_equal(port.active, ref.active)
    key = jax.random.PRNGKey(seed + 1)
    n_ep = tt.n_endpoints
    draws = {}
    if pattern == "uniform":
        draws[(0, "dst")] = Draw("randint", (0, n_ep - 1), np.asarray(
            jax.random.randint(key, (n_ep,), 0, n_ep - 1)))
    elif pattern == "shift":
        draws[(0, "dst")] = Draw("bernoulli", 0.5, np.asarray(
            jax.random.bernoulli(key, 0.5, (n_ep,))))
    src = ReplaySource(draws)
    src.begin_cycle(0)
    got = port.make_sampler(torch.device("cpu"))(src).numpy()
    src.finish()
    want = np.asarray(ref.sample(key))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    if pattern in ("uniform", "worstcase_sf"):
        # active senders target other endpoints (bit permutations have
        # fixed points, e.g. shuffle's 0 -> 0)
        act = port.active
        assert (got[act] != np.arange(n_ep)[act]).all()


@pytest.mark.parametrize("kind", ["healthy", "masked"])
@pytest.mark.parametrize("pattern", ["uniform", "shift", "bitrev",
                                     "worstcase_sf"])
@pytest.mark.parametrize("mode", ["min", "val", "ugal_l", "ugal_g"])
def test_simulate_matches_reference_under_replay(mode, pattern, kind):
    port, ref = run_both(5, kind, pattern, mode)
    assert ref.delivered > 0
    assert_results_equal(port, ref)


def test_simulate_matches_reference_q7_and_stale_tables():
    """One q=7 run on a masked fabric, and one run on stale tables
    (dead ports, routes not re-converged) where UGAL-G's path
    occupancy reads through a dead port."""
    port, ref = run_both(7, "masked", "uniform", "ugal_g", cycles=60,
                         warmup=20)
    assert_results_equal(port, ref)
    port, ref = run_both(5, "stale", "uniform", "ugal_g",
                         injection_rate=0.6)
    assert_results_equal(port, ref)
    assert ref.saturated          # packets routed into dead ports pile up


def test_replay_source_refuses_a_mismatch():
    """A replayed run that asks for a draw it was not given, of another
    kind, or leaves draws unused, raises."""
    _, tt = both_tables(5, "healthy")
    tr = make_traffic(tt, "uniform")
    cfg = SimConfig(injection_rate=0.3, cycles=3, warmup=0, mode="val")
    draws = open_loop_draws(0, 3, 0.3, tt.n_endpoints, tt.n_routers, 4,
                            "uniform", "val")
    simulate(tt, tr, cfg, device="cpu", source=ReplaySource(draws))
    with pytest.raises(ValueError, match="asked for"):
        simulate(tt, tr, dataclasses.replace(cfg, mode="ugal_l"),
                 device="cpu", source=ReplaySource(draws))
    with pytest.raises(LookupError):
        simulate(tt, tr, dataclasses.replace(cfg, cycles=4), device="cpu",
                 source=ReplaySource(draws))
    with pytest.raises(ValueError, match="never used"):
        simulate(tt, tr, dataclasses.replace(cfg, cycles=2), device="cpu",
                 source=ReplaySource(draws))


# ---------------------------------------------------------------------------
# native source: the SF cases of tests/test_sim.py on the port

def sim(pattern, **kw):
    _, tt = both_tables(5, "healthy")
    return simulate(tt, make_traffic(tt, pattern), SimConfig(**kw),
                    device="cpu")


@pytest.mark.parametrize("rate", [0.1, 0.9])
def test_flit_conservation_every_cycle(rate):
    r = sim("uniform", injection_rate=rate, cycles=400, warmup=0,
            mode="min", seed=1)
    cum_inj = np.cumsum(r.per_cycle_injected)
    cum_dlv = np.cumsum(r.per_cycle_delivered)
    np.testing.assert_array_equal(cum_inj, cum_dlv + r.per_cycle_in_flight)
    assert int(cum_inj[-1]) == r.injected
    assert int(cum_dlv[-1]) == r.delivered
    assert int(r.per_cycle_dropped.sum()) == r.dropped_at_source
    assert (r.per_cycle_in_flight >= 0).all()
    if rate >= 0.9:
        assert r.saturated


def test_low_load_latency_is_distance():
    r = sim("uniform", injection_rate=0.05, cycles=500, warmup=200)
    assert r.avg_latency < 5.0
    assert r.accepted_load == pytest.approx(0.05, abs=0.01)


def test_min_beats_val_latency_and_val_saturates_below_half():
    rmin = sim("uniform", injection_rate=0.2, cycles=500, warmup=200,
               mode="min")
    rval = sim("uniform", injection_rate=0.2, cycles=500, warmup=200,
               mode="val")
    assert rmin.avg_latency < rval.avg_latency
    r = sim("uniform", injection_rate=0.8, cycles=600, warmup=300,
            mode="val")
    assert r.accepted_load < 0.5


def test_worstcase_min_collapses():
    kw = dict(injection_rate=0.5, cycles=600, warmup=300)
    rmin = sim("worstcase_sf", mode="min", **kw)
    rval = sim("worstcase_sf", mode="val", **kw)
    rugal = sim("worstcase_sf", mode="ugal_l", **kw)
    assert rmin.accepted_load < 0.15
    assert rval.accepted_load > rmin.accepted_load * 2
    assert rugal.accepted_load > rmin.accepted_load * 2


def test_ugal_l_tracks_min_at_low_load():
    kw = dict(injection_rate=0.1, cycles=500, warmup=200)
    rmin = sim("uniform", mode="min", **kw)
    ru = sim("uniform", mode="ugal_l", **kw)
    assert ru.avg_latency < rmin.avg_latency + 3.0


def test_deterministic_given_seed():
    cfg = dict(injection_rate=0.3, cycles=200, warmup=50, mode="ugal_g",
               seed=11)
    r1, r2 = sim("uniform", **cfg), sim("uniform", **cfg)
    assert_results_equal(r1, r2)
    r3 = sim("uniform", **dict(cfg, seed=12))
    assert r3.injected != r1.injected


def test_torch_source_streams():
    """The native source: Bernoulli at rate p, randint on [low, high),
    int32 and on the asked device; an unknown stream raises."""
    src = TorchSource(0, "cpu")
    src.begin_cycle(0)
    coin = src.bernoulli("inj", 0.25, (20_000,))
    assert coin.dtype == torch.bool
    assert coin.float().mean().item() == pytest.approx(0.25, abs=0.02)
    d = src.randint("route", (500, 4), 3, 9)
    assert d.dtype == torch.int32 and d.shape == (500, 4)
    assert int(d.min()) == 3 and int(d.max()) == 8
    with pytest.raises(ValueError):
        src.randint("nope", (1,), 0, 2)


def test_latency_fold_is_the_references_float32_order():
    """Per-cycle latency sums near saturation at q=19 pass 2^24, where
    float32 addition stops being associative: the host fold adds the
    per-offset int32 sums in the reference's order (its fold adds one
    offset at a time into a float32 total inside the scan)."""
    from repro_torch.sim.engine import _fold_latency
    rng = np.random.default_rng(0)
    lat_w = rng.integers(1 << 22, 1 << 25, (64, 6)).astype(np.int32)

    @jax.jit
    def ref_fold(lw):
        acc = jnp.zeros(lw.shape[0], jnp.float32)
        for w in range(lw.shape[1]):
            acc = acc + lw[:, w].astype(jnp.float32)
        return acc

    want = np.asarray(ref_fold(jnp.asarray(lat_w)))
    got = _fold_latency(lat_w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # another order gives other float32 sums, so the check has teeth
    other = lat_w[:, ::-1].astype(np.float32).cumsum(axis=1, dtype=np.float32)
    assert (other[:, -1] != want).any()
