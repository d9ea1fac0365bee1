"""The shared-memory wire of one host's ranks (distributed/shm.py).

The protocol cases map one file from several ``Wire`` objects of this
process, one per rank, so they need no spawn.  The routing cases run one
spawn of 4 gloo CPU ranks: small messages and sums go through the wire,
a message larger than a slot through gloo, the list form of
``comm.exchange_along`` equals one call per vector, and the sharded
PIPECG and p-BiCGStab bodies give the same histories on the wire as on
gloo alone.
"""
from __future__ import annotations

import torch_cores  # noqa: F401  (first: caps torch's threads)
import threading

import numpy as np
import pytest
import torch

from repro_torch.distributed import shm


@pytest.fixture
def wires(tmp_path):
    made = []

    def make(world):
        path = str(tmp_path / f"wire{len(made)}")
        shm.create(path, world)
        ws = [shm.Wire(path, r, world) for r in range(world)]
        made.extend(ws)
        return ws

    yield make
    for w in made:
        w.close()


def _sum_all(ws, parts, op="sum"):
    ks = [w.post(p.clone()) for w, p in zip(ws, parts)]
    assert len(set(ks)) == 1
    return [w.result(k, torch.empty_like(p), op)
            for w, k, p in zip(ws, ks, parts)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_sums_are_the_rank_order_sum_on_every_rank(wires, dtype):
    ws = wires(3)
    g = torch.Generator().manual_seed(5)
    parts = [torch.randn(4, 7, generator=g).to(dtype) for _ in ws]
    want = parts[0].clone()
    for p in parts[1:]:
        want += p
    for got in _sum_all(ws, parts):
        assert got.dtype == dtype and torch.equal(got, want)
    top = torch.maximum(torch.maximum(parts[0], parts[1]), parts[2])
    for got in _sum_all(ws, parts, op="max"):
        assert torch.equal(got, top)


def test_sums_in_flight_and_around_the_ring(wires):
    ws = wires(2)
    for k in range(3 * shm.SUM_SLOTS):
        a = torch.tensor([float(k), 1.0], dtype=torch.float64)
        ka = [w.post(a * (r + 1)) for r, w in enumerate(ws)]
        kb = [w.post(a + 10.0 * (r + 1)) for r, w in enumerate(ws)]
        # the later sum is read first, as a blocking sum inside a
        # split-phase window would be
        for w, k2 in zip(ws, kb):
            got = w.result(k2, torch.empty(2, dtype=torch.float64))
            assert got.tolist() == [2 * k + 30.0, 32.0]
        for w, k1 in zip(ws, ka):
            got = w.result(k1, torch.empty(2, dtype=torch.float64))
            assert got.tolist() == [3.0 * k, 3.0]


def test_messages_arrive_in_order_and_wait_for_room(wires):
    w0, w1 = wires(2)
    count = 3 * shm.MAIL_SLOTS
    msgs = [torch.arange(5, dtype=torch.int8) + m for m in range(count)]
    sender = threading.Thread(
        target=lambda: [w0.send(1, m) for m in msgs])
    sender.start()
    got = []
    for _ in range(count):
        out = torch.empty(5, dtype=torch.int8)
        w1.recv(0, out)
        got.append(out)
    sender.join(timeout=30)
    assert not sender.is_alive()
    assert all(torch.equal(a, b) for a, b in zip(got, msgs))


def test_a_message_of_another_size_raises(wires):
    w0, w1 = wires(2)
    w0.send(1, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="receive buffer"):
        w1.recv(0, torch.empty(2, dtype=torch.float64))


def test_a_wait_for_an_absent_rank_times_out(wires, monkeypatch):
    monkeypatch.setattr(shm, "TIMEOUT_S", 0.05)
    w0, _ = wires(2)
    k = w0.post(torch.ones(3))
    with pytest.raises(RuntimeError, match="waited"):
        w0.result(k, torch.empty(3))


def test_fits_is_one_slot(wires):
    w0, _ = wires(2)
    assert w0.fits(torch.empty(shm.SLOT // 8, dtype=torch.float64))
    assert not w0.fits(torch.empty(shm.SLOT // 8 + 1, dtype=torch.float64))


# ---------------------------------------------------------------------------
# one spawn of 4 gloo CPU ranks
# ---------------------------------------------------------------------------

def _routing_body(rank, world):
    import torch.distributed as dist

    from repro_torch.core.krylov import (convection_diffusion, pipecg,
                                         tridiagonal_laplacian)
    from repro_torch.core.krylov.bicgstab import pipebicgstab
    from repro_torch.core.krylov.distributed import distributed_solve
    from repro_torch.distributed import comm

    wire = shm.current()
    out = {"attached": wire is not None}
    # a small and a large message to each neighbour, a sum of each size
    lo = rank - 1 if rank > 0 else None
    hi = rank + 1 if rank < world - 1 else None
    small = torch.full((3,), float(rank), dtype=torch.float64)
    big = torch.full((shm.SLOT // 8 + 5,), float(rank), dtype=torch.float64)
    sent = list(wire._out)
    got = {}
    sends, recvs = [], []
    for peer in (lo, hi):
        if peer is not None:
            got[peer] = (torch.empty_like(small), torch.empty_like(big))
            sends += [(peer, small), (peer, big)]
            recvs += [(peer, got[peer][0]), (peer, got[peer][1])]
    comm.exchange(sends, recvs)
    out["p2p_ok"] = all(bool((s == p).all() and (b == p).all())
                        for p, (s, b) in got.items())
    out["wire_messages"] = sum(wire._out) - sum(sent)
    out["sum_small"] = comm.all_reduce(small).tolist()
    out["sum_big"] = float(comm.all_reduce(big).max())

    # the list form against one call per vector
    g = torch.Generator().manual_seed(rank)
    vs = [torch.randn(2, 9, generator=g) for _ in range(3)]
    before = dict(comm.exchange_along.sends)
    pairs = comm.exchange_along(vs, 2, -1, lo, hi)
    listed = {f: comm.exchange_along.sends[f] - before.get(f, 0)
              for f in comm.exchange_along.sends}
    singles = [comm.exchange_along(v, 2, -1, lo, hi) for v in vs]
    out["list_equal"] = all(torch.equal(a, c) and torch.equal(b, d)
                            for (a, b), (c, d) in zip(pairs, singles))
    out["list_sends"] = {f: c for f, c in listed.items() if c}

    # the sharded bodies on the wire and on gloo alone
    n = 64
    cases = {"pipecg": (pipecg, tridiagonal_laplacian(n, device="cpu")),
             "pipebicgstab": (pipebicgstab,
                              convection_diffusion(n, device="cpu"))}
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(n))
    for name, (fn, A) in cases.items():
        hist = []
        for on_wire in (True, False):
            shm._WIRE = wire if on_wire else None
            res = distributed_solve(fn, A, b, None, engine="sharded_fused",
                                    maxiter=12, tol=0.0)
            hist.append(res.res_history.numpy())
        shm._WIRE = wire
        out[name] = hist
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def routed():
    from repro_torch.distributed import ranks
    return ranks.run(_routing_body, 4, device="cpu")


def test_every_gloo_rank_maps_the_wire(routed):
    assert all(o["attached"] for o in routed)


def test_small_messages_ride_the_wire_large_ones_gloo(routed):
    for rank, o in enumerate(routed):
        neighbours = (rank > 0) + (rank < 3)
        assert o["p2p_ok"]
        assert o["wire_messages"] == neighbours      # only the small ones
        assert o["sum_small"] == [6.0, 6.0, 6.0]
        assert o["sum_big"] == 6.0


def test_list_exchange_equals_one_call_per_vector(routed):
    for rank, o in enumerate(routed):
        assert o["list_equal"]
        want = {}
        if rank > 0:
            want["-1:lo"] = 3
        if rank < 3:
            want["-1:hi"] = 3
        assert o["list_sends"] == want


@pytest.mark.parametrize("solver", ["pipecg", "pipebicgstab"])
def test_sharded_bodies_agree_on_the_wire_and_on_gloo(routed, solver):
    for o in routed:
        on_wire, on_gloo = o[solver]
        np.testing.assert_allclose(on_wire, on_gloo, rtol=1e-12, atol=0)
    # every rank reads the same sums
    for o in routed[1:]:
        np.testing.assert_array_equal(o[solver][0], routed[0][solver][0])
