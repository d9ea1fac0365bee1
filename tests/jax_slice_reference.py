"""The JAX package's sharded bodies on forced host devices, for the port's
wire and elastic-recovery tests (tests/test_torch_wire.py,
tests/test_torch_fault.py).

Under this JAX the Pallas halo sweeps do not run (ROADMAP.md queue 3,
H1), so :func:`patch_sweeps` replaces ``repro.kernels.ops.
pipecg_spmv_halo_step``, ``pipebicgstab_halo_step`` and
``ghost_chain_halo_step`` with the TPU kernels' arithmetic in jnp at
their dtypes: loads widen to x's dtype,
the vectors extend by their neighbours' strips, the operator by h zero
rows, the stores narrow back, and the column sums of the checksum entry
are those of the (possibly demoted) extension the JAX wrappers sum.
Nothing in the JAX package changes.

``run(cfg)`` is the body of ONE subprocess (x64, ``cfg["devices"]``
forced host devices, ``--xla_allow_excess_precision=false`` so that bf16
arithmetic rounds after every operation, as torch's does) that computes
every requested reference case and pickles them into one file.  Callers
start it with :func:`start` and read it with :func:`finish`; the JAX
solves run under ``jax.jit`` (:func:`jit_distributed_solve`).
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
HERE = str(Path(__file__).resolve().parent)


def patch_sweeps():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.checksum import dia_column_checksum

    def spmv(offsets, bands, v):
        h = max(abs(o) for o in offsets)
        n = v.shape[-1]
        ve = jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(h, h)])
        y = jnp.zeros_like(v)
        for k, off in enumerate(offsets):
            y = y + bands[k].astype(v.dtype) * ve[..., h + off:h + off + n]
        return y

    def pad(v, w):
        return jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(w, w)])

    def pipecg_halo(offsets, bands_ext, invd_ext, x, r, u, p, u_l, u_r,
                    p_l, p_r, alpha, beta, **_):
        acc = x.dtype
        h = max(abs(o) for o in offsets)
        n = x.shape[-1]
        loc = slice(2 * h, 2 * h + n)
        csum = dia_column_checksum(offsets, bands_ext, halo=h)
        bands = pad(bands_ext, h).astype(acc)
        a = jnp.asarray(alpha, acc)[:, None]
        b = jnp.asarray(beta, acc)[:, None]
        u_e = jnp.concatenate([u_l, u, u_r], axis=-1).astype(acc)
        p_e = jnp.concatenate([p_l, p, p_r], axis=-1).astype(acc)
        p2 = u_e + b * p_e
        s2 = spmv(offsets, bands, p2)
        q2 = pad(invd_ext, h).astype(acc) * s2
        x2 = x + a * p2[:, loc]
        r2 = r.astype(acc) - a * s2[:, loc]
        u2 = u_e - a * q2
        w2 = spmv(offsets, bands, u2)[:, loc]
        u2 = u2[:, loc]
        cs = csum.astype(acc)
        red = jnp.stack([jnp.sum(r2 * u2, -1), jnp.sum(w2 * u2, -1),
                         jnp.sum(r2 * r2, -1), jnp.sum(r2 * w2, -1),
                         jnp.sum(w2 * w2, -1),
                         jnp.sum(w2, -1) - jnp.sum(cs * u2, -1)], axis=-1)
        return (x2, r2.astype(r.dtype), u2.astype(u.dtype),
                p2[:, loc].astype(p.dtype), red)

    def bicgstab_halo(offsets, bands_ext, x, r, w, t, pa, a, c, r_hat,
                      w_l, w_r, t_l, t_r, c_l, c_r, alpha, beta, omega, **_):
        acc = x.dtype
        h = max(abs(o) for o in offsets)
        n = x.shape[-1]
        loc = slice(2 * h, 2 * h + n)
        csum = dia_column_checksum(offsets, bands_ext, halo=h)
        bands = pad(bands_ext, h).astype(acc)
        al, be, om = (jnp.asarray(s, acc) for s in (alpha, beta, omega))
        r_, pa_, a_, rh = (pad(v, 2 * h).astype(acc)
                           for v in (r, pa, a, r_hat))
        w_, t_, c_ = (jnp.concatenate([lo, v, hi]).astype(acc)
                      for lo, v, hi in ((w_l, w, w_r), (t_l, t, t_r),
                                        (c_l, c, c_r)))
        pp = r_ + be * pa_
        s = w_ + be * a_
        z = t_ + be * c_
        v = spmv(offsets, bands, z)
        q = r_ - al * s
        y = w_ - al * z
        x2 = x + al * pp[loc] + om * q[loc]
        r2 = q - om * y
        w2 = y - om * (t_ - al * v)
        t2 = spmv(offsets, bands, w2)
        pa2 = pp - om * s
        a2 = s - om * z
        c2 = z - om * v
        C = jnp.stack([r2, w2, t2, a2, c2, rh])[:, loc]
        chk = jnp.sum(C[2]) - jnp.sum(csum.astype(acc) * C[1])
        G = jnp.concatenate([C @ C.T, jnp.zeros((1, 6), acc)])
        G = G.at[6, 0].set(chk)
        return (x2, r2[loc].astype(r.dtype), w2[loc].astype(w.dtype),
                t2[loc].astype(t.dtype), pa2[loc].astype(pa.dtype),
                a2[loc].astype(a.dtype), c2[loc].astype(c.dtype), G)

    def chain_halo(offsets, bands_ext, p, r, p_l, p_r, r_l, r_r, theta, l,
                   accum_dtype=None, **_):
        acc = accum_dtype or jnp.promote_types(p.dtype, jnp.float32)
        h = max(abs(o) for o in offsets)
        H, n = l * h, p.shape[0]
        th_inv = 1.0 / jnp.asarray(theta, acc)
        bands = bands_ext.astype(acc)

        def links(v, depth):
            a = v.astype(acc)
            out = [a[H:H + n]]
            for j in range(1, depth + 1):
                width = n + 2 * (H - j * h)
                nxt = jnp.zeros((width,), acc)
                for k, off in enumerate(offsets):
                    nxt = nxt + bands[k, j * h:j * h + width] \
                        * a[h + off:h + off + width]
                a = nxt * th_inv
                out.append(a[H - j * h:H - j * h + n])
            return out

        C = jnp.stack(links(jnp.concatenate([p_l, p, p_r]), l)
                      + links(jnp.concatenate([r_l, r, r_r]), l - 1))
        return C.astype(p.dtype), C @ C.T

    jops.pipecg_spmv_halo_step = pipecg_halo
    jops.pipebicgstab_halo_step = bicgstab_halo
    jops.ghost_chain_halo_step = chain_halo


def precision_problems(n: int):
    """The precision stage's operators (experiments/precision_exec.py)."""
    import numpy as np

    def band(offsets, diag):
        i = np.arange(n)
        return np.stack([np.full(n, diag) if o == 0 else
                         np.where((i + o >= 0) & (i + o < n), -1.0, 0.0)
                         for o in offsets])

    # the stage's bands are -1 and 3 for p-BiCGStab, exact in bf16; the
    # rounded variant's 3.1 becomes 3.09375 there (the H9 check)
    return {"pipecg": ((-128, -1, 0, 1, 128), band((-128, -1, 0, 1, 128),
                                                   4.1)),
            "pipebicgstab": ((-1, 0, 1), band((-1, 0, 1), 3.0)),
            "pipebicgstab-rounded": ((-1, 0, 1), band((-1, 0, 1), 3.1))}


def elastic_problem(n: int = 240):
    """test_elastic.py's operator and right-hand side (numpy)."""
    import numpy as np
    i = np.arange(n)
    bands = np.stack([np.where(i >= 1, -1.0, 0.0), np.full(n, 3.0),
                      np.where(i < n - 1, -1.0, 0.0)])
    return (-1, 0, 1), bands, np.random.default_rng(0).standard_normal(n)


def x0_of(n: int):
    """The restart iterate of the ``x0=`` case."""
    import numpy as np
    return np.random.default_rng(7).standard_normal(n)


def _result(res):
    import numpy as np
    out = {}
    for k in ("x", "iters", "res_norm", "res_history", "detect_history"):
        v = getattr(res, k)
        out[k] = None if v is None else np.asarray(v)
    return out


def _wire_cases(cfg, out):
    import functools

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import jax
    import repro.core.krylov as jk
    from repro.core.krylov.operators import DiaMatrix

    if not cfg.get("wire"):
        return
    probs = precision_problems(cfg["n"])
    rng = np.random.default_rng(cfg["seed"])
    rhs = {"pipecg": rng.standard_normal(cfg["n"]),
           "pipebicgstab": np.ones(cfg["n"])}
    for case in cfg["wire"]:
        solver, policy, world, iters = (case["solver"], case["policy"],
                                        case["world"], case["maxiter"])
        problem = case.get("problem", solver)
        offs, bands = probs[problem]
        A = DiaMatrix(offsets=offs, bands=jnp.asarray(bands))
        mesh = Mesh(np.asarray(jax.devices()[:world]), ("shards",))
        opts = jk.SolverOptions(maxiter=iters, engine="sharded_fused",
                                precision=jk.PrecisionPolicy.from_name(
                                    policy))
        res = jax.jit(functools.partial(
            jk.distributed_solve, getattr(jk, solver), A, mesh=mesh,
            options=opts))(jnp.asarray(rhs[solver]))
        out[f"wire/{problem}/{policy}/{world}"] = _result(res)


def _elastic_cases(cfg, out):
    import dataclasses
    import tempfile

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import repro.core.krylov as jk
    from repro.core.krylov import distributed as jdist
    from repro.core.krylov.operators import DiaMatrix
    from repro.core.noise.faults import FaultInjector, make_faults
    from repro.distributed.fault import resilient_distributed_solve

    if not cfg.get("elastic"):
        return
    offs, bands, b = elastic_problem(cfg.get("elastic_n", 240))
    A = DiaMatrix(offsets=offs, bands=jnp.asarray(bands))
    b = jnp.asarray(b)
    devs = jax.devices()
    for case in cfg["elastic"]:
        name = case["name"]
        if name == "handoff":
            m4 = Mesh(np.asarray(devs[:4]), ("shards",))
            m2 = Mesh(np.asarray(devs[:2]), ("shards",))
            kw = dict(engine="sharded_fused", tol=0.0)
            ref = jdist.distributed_solve(jk.pipecg, A, b, m4, maxiter=40,
                                          **kw)
            r1, st = jdist.distributed_solve(jk.pipecg, A, b, m4,
                                             maxiter=10, with_state=True,
                                             **kw)
            st = {k: np.asarray(v) for k, v in st.items()}
            r2 = jdist.distributed_solve(jk.pipecg, A, b, m2, maxiter=30,
                                         carried=st, **kw)
            out["elastic/handoff/straight"] = _result(ref)
            out["elastic/handoff/first"] = _result(r1)
            out["elastic/handoff/state"] = st
            out["elastic/handoff/second"] = _result(r2)
            continue
        if name == "x0":
            m4 = Mesh(np.asarray(devs[:4]), ("shards",))
            res = jdist.distributed_solve(
                jk.pipecg, A, b, m4, engine="sharded_fused", tol=0.0,
                maxiter=15, x0=jnp.asarray(x0_of(b.shape[0])))
            out["elastic/x0"] = _result(res)
            continue
        inj = None
        if case.get("faults"):
            inj = FaultInjector(faults=make_faults(
                case["faults"], **case.get("fault_kw", {})), n_shards=4,
                seed=case.get("seed", 0))
        opts = None
        if case.get("precision"):
            opts = jk.SolverOptions(
                maxiter=case["maxiter"], tol=case["tol"],
                precision=jk.PrecisionPolicy.from_name(case["precision"]))
            kw = dict(options=opts)
        else:
            kw = dict(tol=case["tol"], maxiter=case["maxiter"])
        with tempfile.TemporaryDirectory() as d:
            res, rep = resilient_distributed_solve(
                A, b, devs[:4], injector=inj, ckpt_dir=d,
                checkpoint_period=case["period"], **kw)
        rep = dataclasses.asdict(rep)
        rep.pop("wall_s")
        rep.pop("segment_walls")
        out[f"elastic/{name}"] = dict(result=_result(res), report=rep)


def _campaign_cases(cfg, out):
    """The JAX package's campaign stages on the same configurations as the
    port's (tests/test_torch_campaign_exec.py): the execution cells of
    ``runner`` on the naive engine, and each rank stage's ``_run_cells``
    worker body, run here in-process on the forced host devices."""
    from repro.experiments import (abft_exec, fault_exec, geometry_exec,
                                   precision_exec)
    from repro.experiments import runner as jrunner
    from repro.experiments.noise_sources import make_distribution

    c = cfg.get("campaign") or {}
    if "engine" in c:
        out["campaign/engine"] = jrunner.run_engine_exec(**c["engine"])
    if "depth" in c:
        out["campaign/depth"] = jrunner.run_depth_exec(**c["depth"])
    if "noisy" in c:
        kw = dict(c["noisy"])
        kw["dist"] = make_distribution(kw.pop("noise"))
        out["campaign/noisy"] = jrunner.run_noisy_exec(**kw)
    for name, stage in (("fault", fault_exec), ("abft", abft_exec),
                        ("precision", precision_exec),
                        ("precision_window", precision_exec),
                        ("geometry", geometry_exec)):
        if name in c:
            out[f"campaign/{name}"] = stage._run_cells(c[name])


def jit_distributed_solve():
    """Run each ``distributed_solve`` of the JAX package under ``jax.jit``.

    Eager shard_map dispatches the body's set-up op by op (about 10 s a
    solve on 4 forced host devices); one compiled call gives the same
    numbers in about 1 s.  ``resilient_distributed_solve`` looks the
    function up at call time, so its segments run compiled too.
    """
    import jax
    from repro.core.krylov import distributed as jdist

    orig = jdist.distributed_solve

    def jitted(solver, A, b, mesh, *, x0=None, carried=None, **kw):
        def f(b, x0, carried):
            return orig(solver, A, b, mesh, x0=x0, carried=carried, **kw)
        return jax.jit(f)(b, x0, carried)

    jdist.distributed_solve = jitted


def run(cfg):
    import jax
    jax.config.update("jax_enable_x64", True)
    patch_sweeps()
    jit_distributed_solve()
    out = {}
    _wire_cases(cfg, out)
    _elastic_cases(cfg, out)
    _campaign_cases(cfg, out)
    with open(cfg["out"], "wb") as f:
        pickle.dump(out, f)


def start(cfg):
    """Start the reference subprocess; returns the Popen."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    # one compute thread a device: the test runs beside other workers
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{cfg['devices']} --xla_allow_excess_precision=false"
                        " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1")
    script = (f"import sys; sys.path.insert(0, {HERE!r}); "
              "import json, jax_slice_reference as r; "
              f"r.run(json.loads({json.dumps(cfg)!r}))")
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, out_path, timeout=900):
    """Wait for the subprocess and load its results."""
    stdout, stderr = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{stdout}\n"
                           f"{stderr[-6000:]}")
    with open(out_path, "rb") as f:
        return pickle.load(f)
