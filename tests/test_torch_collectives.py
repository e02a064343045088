"""The port's ring collectives (`repro_torch.dist.collectives`) and EF-int8
compression (`repro_torch.optim.compression`) on a world of 8 gloo ranks
(CPU processes started here), held against the reference's `shard_map`
runs on 8 forced host devices (a subprocess; the test process keeps
seeing one device):

- `ring_all_reduce` (8 ranks, [37] each) and `ring_reduce_scatter` then
  `ring_all_gather` (a group of 4 ranks, [8, 3] each): EQUAL, since every
  ring step adds ``cur + recv`` in the reference's order;
- `collective_matmul_ag` (8 ranks) within 1e-6 relative, the send and
  receive of step i+1 posted before the product of step i;
- `compressed_psum` (8 ranks, [1024] each): phase-1 codes EQUAL, the mean
  and the residual within 1e-6 of the reference's largest value, the
  mean within the reference's own 0.05 bar of the exact mean.
"""

import os

import numpy as np
import pytest

from _torch_worlds import finish, reference_env, start_python, start_world

CM_RTOL = 1e-6
PSUM_RTOL = 1e-6

_INPUTS = """
rng = np.random.default_rng(1)
g_ar = rng.standard_normal((8, 37)).astype(np.float32)
g_rs = np.random.default_rng(2).standard_normal((4, 8, 3)).astype(np.float32)
rng = np.random.default_rng(3)
x_cm = rng.standard_normal((64, 32)).astype(np.float32)
w_cm = rng.standard_normal((32, 16)).astype(np.float32)
g_ps = np.random.default_rng(0).standard_normal((8, 1024)).astype(np.float32)
"""

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.collectives import (collective_matmul_ag, ring_all_gather,
                                    ring_all_reduce, ring_reduce_scatter)
from repro.optim.compression import _quant, compressed_psum
""" + _INPUTS + """
out = sys.argv[1] if len(sys.argv) > 1 else None
m8 = Mesh(np.array(jax.devices()[:8]), ("d",))
m4 = Mesh(np.array(jax.devices()[:4]), ("d",))
sm = lambda f, mesh, i, o: jax.shard_map(f, mesh=mesh, in_specs=i,
                                         out_specs=o, check_vma=False)
ar = sm(lambda x: ring_all_reduce(x[0], "d")[None], m8, P("d", None),
        P("d", None))(g_ar)
rs = sm(lambda x: ring_reduce_scatter(x[0], "d"), m4, P("d", None, None),
        P("d", None))(g_rs)
ag = sm(lambda x: ring_all_gather(ring_reduce_scatter(x[0], "d"), "d")
        .reshape(1, 8, 3), m4, P("d", None, None), P("d", None, None))(g_rs)
cm = sm(lambda xs, ws: collective_matmul_ag(xs, ws, "d")[None], m8,
        (P("d", None), P(None, None)), P("d", None, None))(x_cm, w_cm)
def body(x):
    o, e = compressed_psum(x[0], "d")
    return o[None], e[None]
ps, pe = sm(body, m8, P("d", None), (P("d", None), P("d", None)))(g_ps)
codes = np.stack([np.asarray(_quant(jnp.asarray(r))[0]) for r in g_ps])
np.savez(OUT + "/reference.npz", ar=ar, rs=rs, ag=ag, cm=cm, ps=ps, pe=pe,
         codes=codes)
"""

_WORLD = """
from torch.utils._python_dispatch import TorchDispatchMode
import repro_torch.dist.collectives as C
from repro_torch.optim.compression import _quant, compressed_psum
""" + _INPUTS + """
res = {}
res["ar"] = C.ring_all_reduce(torch.from_numpy(g_ar[RANK]))
grp = dist.new_group([0, 1, 2, 3])
if RANK < 4:
    rs = C.ring_reduce_scatter(torch.from_numpy(g_rs[RANK]), grp)
    res["rs"] = rs
    res["ag"] = C.ring_all_gather(rs, grp).reshape(8, 3)

# the order of the overlapped ring matmul's posts, products and waits
log = []
post = C._post


class _Req:
    def __init__(self, req):
        self.req = req

    def wait(self):
        log.append("wait")
        return self.req.wait()


def logged_post(send, recv, ring):
    log.append("post")
    return [_Req(r) for r in post(send, recv, ring)]


class _Products(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            log.append("mm")
        return func(*args, **(kwargs or {}))


C._post = logged_post
with _Products():
    res["cm"] = C.collective_matmul_ag(
        torch.from_numpy(x_cm[RANK * 8:(RANK + 1) * 8]),
        torch.from_numpy(w_cm))
C._post = post
order = [e for i, e in enumerate(log) if i == 0 or e != log[i - 1]]

g = torch.from_numpy(g_ps[RANK])
res["codes"] = _quant(g)[0]
res["ps"], res["pe"] = compressed_psum(g)
np.savez(OUT + f"/rank{RANK}.npz", order=np.array(order),
         **{k: v.numpy() for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's per-rank results and the reference's, run at once."""
    out = str(tmp_path_factory.mktemp("collectives"))
    procs = start_world(8, _WORLD, out)
    procs += start_python(f"OUT = {out!r}\n" + _REFERENCE,
                          env_extra=reference_env(8))
    finish(procs, timeout=300)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(8)]
    return ranks, dict(np.load(os.path.join(out, "reference.npz")))


def test_ring_all_reduce_equals_reference(runs):
    ranks, ref = runs
    for r in range(8):
        np.testing.assert_array_equal(ranks[r]["ar"], ref["ar"][r])


def test_ring_reduce_scatter_and_all_gather_equal_reference(runs):
    """Rank d's reduce-scatter output is chunk d; gathering the chunks
    reassembles the all-reduce with no block permutation."""
    ranks, ref = runs
    np.testing.assert_array_equal(
        np.concatenate([ranks[r]["rs"] for r in range(4)]), ref["rs"])
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["ag"], ref["ag"][r])
    assert "rs" not in ranks[4]


def test_collective_matmul_ag_matches_and_overlaps(runs):
    ranks, ref = runs
    exec(_INPUTS, ns := {"np": np})
    want = ns["x_cm"] @ ns["w_cm"]
    for r in range(8):
        got = ranks[r]["cm"]
        scale = np.abs(ref["cm"][r]).max()
        assert np.abs(got - ref["cm"][r]).max() / scale < CM_RTOL
        assert np.abs(got - want).max() / scale < CM_RTOL
        # step i+1's send and receive are posted before product i and
        # waited on after it; the last shard's product follows the loop
        assert list(ranks[r]["order"]) == ["post", "mm", "wait"] * 7 + ["mm"]


def test_compressed_psum_matches_reference(runs):
    ranks, ref = runs
    exec(_INPUTS, ns := {"np": np})
    g = ns["g_ps"]
    for r in range(8):
        np.testing.assert_array_equal(ranks[r]["codes"], ref["codes"][r])
        for k in ("ps", "pe"):
            scale = np.abs(ref[k][r]).max()
            assert np.abs(ranks[r][k] - ref[k][r]).max() / scale \
                < PSUM_RTOL, k
        mean = g.mean(axis=0)
        assert np.abs(ranks[r]["ps"] - mean).max() / np.abs(mean).max() \
            < 0.05
    # error feedback: the mean times n plus every rank's residual is
    # the sum of the inputs (the residuals carry what the wire lost)
    total = 8 * ranks[0]["ps"] + sum(ranks[r]["pe"] for r in range(8))
    np.testing.assert_allclose(total, g.sum(axis=0), atol=1e-5)
