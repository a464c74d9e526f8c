"""The port's drivers across devices against the reference's.

The reference runs ``Engine.run_distributed`` under ``shard_map`` over two
forced host devices, in a child process (``distributed_harness``); the
port runs the same built scenario on two CPU shards. On the 64-flow grid of
``test_torch_network_64.py`` the full states must be byte-equal, pool slot
layouts included, with one agent a shard (K = 1) and with two agents a
shard and one pad agent (3 agents, K = 2). At K = 1 the reference's shard
drops its vmap of size 1, so the max-min sums take the one-lane order, and
its ``run_distributed`` differs from its ``run_local``: the port follows
its ``run_distributed``. Then the ``[distributed]`` lines of both CLIs, at
two devices and 2 agents a device, plain and with ``--migrate``, must be
the same.

The reference's runs compile JAX engine code (about 15 s a configuration).
Its runs across devices go to a child process of two cores a test (both
CLI runs in one), started first, and its ``run_local`` and the port's runs
take place in this process meanwhile; the file holds two tests (see
test_torch_engine.py).
"""
import concurrent.futures
import inspect
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_harness import run_distributed_child  # noqa: E402
from repro.core import Engine as JEngine  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.launch import simulate  # noqa: E402

from test_torch_engine import assert_states_equal, port_scenario  # noqa: E402
from test_torch_network_64 import grid_64_flows  # noqa: E402

# A child keeps to two cores of its own (the ``first`` two of the cores
# this process may use), as a worker of the suite does.
PIN = """
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[{first}:{first} + 2])
"""

CHILD_GRID = PIN.format(first=0) + """
from repro.core.components import DATA_WRITE, FLOW_START, JOB_SUBMIT
{source}

def flat(st):
    return {{f"{{k}}.{{kk}}" if hasattr(v, "_fields") else k:
             np.asarray(vv if hasattr(v, "_fields") else v)
             for k, v in st._asdict().items()
             for kk, vv in (v._asdict().items() if hasattr(v, "_fields")
                            else [(k, v)])}}

mesh = Mesh(np.array(jax.devices()[:2]), ("agents",))
for n in (2, 3):
    b, kw = grid_64_flows()
    built = b.build(**dict(kw, n_agents=n))
    eng = Engine(*built, trace_cap=1024)
    np.savez(os.path.join({out!r}, f"dist{{n}}.npz"),
             **flat(eng.run_distributed(mesh)))
print(json.dumps({{"ok": True}}))
"""

CHILD_CLI = PIN.format(first=0) + """
import contextlib
import io
import sys
from repro.launch import simulate as jsimulate

lines = []
for extra in {extras}:
    sys.argv = ["simulate", "distributed", "--agents-per-device", "2", *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jsimulate.main()
    lines += [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("[distributed]")]
print(json.dumps({{"lines": lines}}))
"""


def np_state(st):
    """A state of either package as numpy arrays keyed ``field`` or
    ``world.field``/``pool.field``."""
    out = {}
    for k, v in st._asdict().items():
        if hasattr(v, "_fields"):
            out.update({f"{k}.{kk}": np.asarray(vv)
                        for kk, vv in v._asdict().items()})
        else:
            out[k] = np.asarray(v)
    return out


def children(*bodies: str) -> list:
    """The reference's children, started now, side by side; a future's
    ``.result()`` waits for its child."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(bodies))
    futs = [pool.submit(run_distributed_child, b, n_devices=2)
            for b in bodies]
    pool.shutdown(wait=False)
    return futs


def test_grid_64_flows_equals_reference_run_distributed():
    with tempfile.TemporaryDirectory() as out:
        [ref_run] = children(CHILD_GRID.format(
            source=inspect.getsource(grid_64_flows), out=out))
        got, ref = {}, {}
        for n in (2, 3):
            b, kw = grid_64_flows()
            built = b.build(**dict(kw, n_agents=n))
            scen = port_scenario(*built)
            got[f"dist{n}"] = np_state(Engine(
                *scen, trace_cap=1024, device="cpu").run_distributed(
                    ["cpu"] * 2))
            if n == 2:
                got["local2"] = np_state(Engine(
                    *scen, trace_cap=1024, device="cpu").run_local())
                ref["local2"] = np_state(
                    JEngine(*built, trace_cap=1024).run_local())
        ref_run.result()
        for n in (2, 3):
            ref[f"dist{n}"] = dict(np.load(os.path.join(out,
                                                        f"dist{n}.npz")))
    # the caveat: one lane a shard sums the flows in the one-lane order
    assert not np.array_equal(ref["dist2"]["world.flow_rate"].view(np.int32),
                              ref["local2"]["world.flow_rate"].view(np.int32))
    for name in ("dist2", "dist3", "local2"):
        assert_states_equal(got[name], ref[name], name)


def test_distributed_cli_lines_equal_reference():
    extras = ([], ["--migrate"])
    # one child runs both reference CLIs (one JAX start-up)
    [ref_run] = children(CHILD_CLI.format(extras=repr(extras)))
    got = []
    for extra in extras:
        got += simulate.main(["distributed", "--device", "cpu", "--devices",
                              "2", "--agents-per-device", "2", *extra])
    assert got == ref_run.result()["lines"]
    assert "migrate_out=" in got[1] and "remote_msgs=" in got[0]
