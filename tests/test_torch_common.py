"""Shared helpers for the PyTorch port's parity tests (holds no tests).

The port (``repro_torch``) is held against the JAX package (``repro``) on
identical inputs: numpy arrays made from fixed seeds go through both, and
the reference's own traces are carried into the port with
``repro_torch.interop``. JAX stays on the CPU; the port runs with
``device="cpu"``, where every kernel wrapper takes its plain version.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import api, pyengine, workload
from repro.core import engine as jengine
from repro.core.policy.context import MachineView, SchedContext
from repro.core.types import SystemArrays
from repro_torch import interop
from repro_torch.core import engine as tengine

CPU = "cpu"
SPEC = api.paper_system()
TSPEC = interop.system_from_arrays(SPEC.eet, SPEC.p_dyn, SPEC.p_idle,
                                   SPEC.queue_size, SPEC.fairness_factor)
HEURISTICS = ("MM", "MSD", "MMU", "MET", "MCT", "RANDOM", "ELARE", "FELARE")
COUNT_FIELDS = ("completed_by_type", "missed_by_type", "cancelled_by_type",
                "arrived_by_type")
ENERGY_FIELDS = ("energy_dynamic", "energy_wasted", "energy_idle")


def dyadic(x):
    """Round to 1/64 so float32 sums do not depend on their order."""
    return (np.round(np.asarray(x) * 64) / 64).astype(np.float32)


def jax_trace(seed: int, n: int, rate: float, eet=None):
    """The reference's Poisson trace, dyadic-rounded as its tests do."""
    eet = SPEC.eet if eet is None else eet
    tr = workload.poisson_trace(jax.random.PRNGKey(seed), n, rate, eet)
    return tr._replace(
        arrival=jnp.asarray(dyadic(tr.arrival)),
        deadline=jnp.asarray(dyadic(tr.deadline)),
        exec_actual=jnp.asarray(dyadic(tr.exec_actual)),
    )


def stack_traces(traces):
    """Stack reference traces into one batched port Trace on the CPU."""
    return interop.trace_from_arrays(
        *(np.stack([np.asarray(getattr(t, f)) for t in traces])
          for f in ("arrival", "task_type", "deadline", "exec_actual")),
        device=CPU)


def assert_metrics_match(ref: dict, port: dict, what: str,
                         energy_rel: float = 1e-5,
                         n_machines: int | None = None) -> None:
    """Counters and makespan identical; energies within ``energy_rel``
    (sums over machines may run in another order). ``n_machines`` is
    given where ``ref`` is the JAX engine's: on a system of up to
    :data:`repro_torch.core.engine.SEQ_SUM_MAX` (8) machines its idle
    energy is then held bit for bit, since the port sums it in the order
    of the reference's compiled code (past 8 machines XLA vectorizes the
    sum; ROADMAP C)."""
    for k in COUNT_FIELDS + ("makespan",):
        np.testing.assert_array_equal(np.asarray(port[k]),
                                      np.asarray(ref[k]),
                                      err_msg=f"{what}: {k}")
    if n_machines is not None and n_machines <= tengine.SEQ_SUM_MAX:
        np.testing.assert_array_equal(np.asarray(port["energy_idle"]),
                                      np.asarray(ref["energy_idle"]),
                                      err_msg=f"{what}: energy_idle")
    for k in ENERGY_FIELDS:
        np.testing.assert_allclose(np.asarray(port[k], np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=energy_rel, err_msg=f"{what}: {k}")


def random_context_arrays(B, N, M, S, Q, seed):
    """B random mapping events as numpy arrays, with adversarial draws:
    full queues, stale tasks, empty machines, tied EET columns."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    eet = r.uniform(0.5, 20, (S, M)).astype(f32)
    if M > 1:
        eet[:, M - 1] = eet[:, 0]
    qlen = r.integers(0, Q + 1, (B, M))
    queue = np.full((B, M, Q), -1, np.int64)
    for b in range(B):
        for m in range(M):
            queue[b, m, :qlen[b, m]] = r.integers(0, N, qlen[b, m])
    return dict(
        now=r.uniform(0, 50, B).astype(f32),
        pending=r.integers(0, 2, (B, N)).astype(bool),
        task_type=r.integers(0, S, (B, N)).astype(np.int64),
        deadline=r.uniform(0, 120, (B, N)).astype(f32),
        avail_base=r.uniform(0, 60, (B, M)).astype(f32),
        queue=queue,
        qlen=qlen.astype(np.int64),
        eet=eet,
        p_dyn=r.uniform(1, 10, M).astype(f32),
        p_idle=r.uniform(0.1, 1, M).astype(f32),
        suffered=r.integers(0, 2, (B, S)).astype(bool),
    )


def jax_context(a: dict, b: int) -> SchedContext:
    """Replicate ``b`` of :func:`random_context_arrays` as a JAX context."""
    return SchedContext(
        now=jnp.float32(a["now"][b]),
        pending=jnp.asarray(a["pending"][b]),
        task_type=jnp.asarray(a["task_type"][b].astype(np.int32)),
        deadline=jnp.asarray(a["deadline"][b]),
        view=MachineView(avail_base=jnp.asarray(a["avail_base"][b]),
                         queue=jnp.asarray(a["queue"][b].astype(np.int32)),
                         qlen=jnp.asarray(a["qlen"][b].astype(np.int32))),
        sysarr=SystemArrays(eet=jnp.asarray(a["eet"]),
                            p_dyn=jnp.asarray(a["p_dyn"]),
                            p_idle=jnp.asarray(a["p_idle"])),
        suffered=jnp.asarray(a["suffered"][b]),
    )


def port_context(a: dict):
    """All replicates of :func:`random_context_arrays` as one port
    context on the CPU."""
    return interop.context_from_arrays(**a, device=CPU)


def to_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# Federation: a reference system carried into the port, and one run of
# each side with the final per-task sites.
# --------------------------------------------------------------------------
def port_spec(spec):
    """The port's SystemSpec of a reference SystemSpec, partitions
    included."""
    return interop.system_from_arrays(
        spec.eet, spec.p_dyn, spec.p_idle, spec.queue_size,
        spec.fairness_factor, site_of_machine=spec.site_of_machine,
        tier_of_site=spec.tier_of_site)


def jax_federated(spec, traces, heuristic, dispatcher, task_log=False):
    """The JAX engine's metrics for a batch of reference traces and the
    oracle's (``pyengine``) per trace: ``(jax_rows, jax_sites,
    oracle_rows)``. ``jax_sites`` are the engine's final task sites from
    its ``task_log`` observer when ``task_log`` is set, else ``None``
    (the observer costs a compile of its own)."""
    batch = jax.tree.map(lambda *xs: np.stack(xs), *traces)
    out = jengine.simulate_batch(
        batch, spec, heuristic, dispatcher=dispatcher,
        observers=("task_log",) if task_log else ())
    m, sites = ((out[0], np.asarray(out[1]["task_log"]["site"]))
                if task_log else (out, None))
    rows = [{k: np.asarray(v)[i] for k, v in m._asdict().items()}
            for i in range(len(traces))]
    oracle = [pyengine.simulate(tr, spec, heuristic, dispatcher=dispatcher)
              for tr in traces]
    return rows, sites, oracle


def port_federated(tspec, traces, heuristic, dispatcher, fused):
    """The port's metrics (numpy, leading B) and its final per-task sites,
    read from the engine's final state."""
    sysarr = tspec.as_torch(CPU)
    run = tengine._make_loop(
        tengine._resolve_policy(heuristic, fused, False), sysarr,
        queue_size=tspec.queue_size,
        fairness_factor=float(tspec.fairness_factor),
        dispatcher=tengine._resolve_dispatcher(dispatcher, fused),
        site_of_machine=tspec.site_of_machine)
    st, _ = run(traces)
    return (interop.metrics_to_numpy(tengine._metrics(st, sysarr)),
            st.site.numpy())


# ------------------------------------------------------- process groups
#: The source tree and this directory: a spawned rank imports the port
#: and the test module that holds its function from them.
_SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
_TESTS = str(pathlib.Path(__file__).resolve().parent)

# What each rank runs: join a gloo group through the file:// store, call
# ``module:function(rank, world, *args)``, pickle its return value. An
# exception leaves its traceback in the rank's log and a non-zero exit.
_RANK_MAIN = """
import datetime, importlib, pathlib, pickle, sys
target, rank, world, where, timeout = sys.argv[1:6]
rank, world, where = int(rank), int(world), pathlib.Path(where)
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch import mesh
mesh.init_distributed("cpu", init_method=f"file://{where}/store", rank=rank,
                      world_size=world,
                      timeout=datetime.timedelta(seconds=float(timeout)))
try:
    mod, name = target.split(":")
    fn = getattr(importlib.import_module(mod), name)
    args = pickle.loads((where / "args.pkl").read_bytes())
    out = fn(rank, world, *args)
    (where / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
finally:
    dist.destroy_process_group()
"""


def spawn_group(target: str, world: int, tmp_path, *, args=(),
                deadline: float = 240.0, timeout: float = 120.0) -> list:
    """Run ``target`` (``"module:function"``, a function of ``(rank,
    world, *args)`` in a module that imports neither JAX nor this one)
    on ``world`` gloo ranks on the CPU, each in a fresh process with one
    torch thread, joined through a ``file://`` store under ``tmp_path``
    (no TCP port, so concurrent test workers never collide).

    Returns the ranks' return values in rank order. Each collective
    gives up after ``timeout`` seconds (the group's own timeout); a rank
    that fails kills the others at once and its log is raised here; at
    ``deadline`` seconds every rank is killed and the call raises: a
    test that spawns a group fails, it never hangs.
    """
    where = pathlib.Path(tempfile.mkdtemp(dir=tmp_path, prefix="group_"))
    (where / "args.pkl").write_bytes(pickle.dumps(tuple(args)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([_SRC, _TESTS]))
    logs = [open(where / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, target, str(r), str(world),
         str(where), str(timeout)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    end = time.monotonic() + deadline
    failed = None
    try:
        while any(p.poll() is None for p in procs) and failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode not in (None, 0)), None)
            if time.monotonic() > end:
                raise TimeoutError(f"{target} on {world} ranks passed its "
                                   f"{deadline:.0f} s deadline")
            time.sleep(0.05)
        failed = next((r for r, p in enumerate(procs) if p.returncode),
                      failed)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed is not None:
        log = (where / f"rank{failed}.log").read_text()
        raise RuntimeError(f"{target}: rank {failed} of {world} failed "
                           f"(exit {procs[failed].returncode}):\n{log}")
    return [pickle.loads((where / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def run_reference(body: str, devices: int, timeout: float = 600.0) -> str:
    """Run ``body`` (Python source) in a fresh process that sees
    ``devices`` placeholder CPU devices, as the JAX package's own
    distributed tests do; returns its standard output."""
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout
