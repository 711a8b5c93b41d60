"""The port's multi-host plane (``anomod_torch.parallel.multihost``):
four processes started with ``torchrun``'s environment set by hand, two
"hosts" of two local ranks each (``LOCAL_WORLD_SIZE=2``), joined over
``gloo`` through ``env://`` on ``127.0.0.1``, each running ``python -m
anomod_torch.parallel.multihost --device cpu`` (the checks of the JAX
package's ``tests/multihost_worker.py``) under a 120 s limit, one torch
thread each.

Exact: the hybrid mesh's shape and slices, the psum over both axes, the
HLL registers merged over the ranks' disjoint item ranges against the
port's single-device plane of their union, and the replicas after the
process-local GCN step (loss and parameters, bit for bit).  The estimate
is held to the JAX test's 5 % of the true distinct count.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from anomod_torch.ops.hll import hll_add, hll_init
from anomod_torch.parallel import launch
from anomod_torch.parallel.multihost import (ENV_KEYS, dcn_data_parallel_spec,
                                             initialize_distributed,
                                             make_hybrid_mesh,
                                             process_local_array,
                                             replicated_value)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
HOSTS, LOCAL = 2, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def hosts():
    """The 4-rank env:// launch: every rank's ``MHRESULT`` document."""
    world, port = HOSTS * LOCAL, _free_port()
    base = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    base.update(PYTHONPATH=os.pathsep.join(
        [REPO] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else [])),
        OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
        WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(LOCAL))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "anomod_torch.parallel.multihost", "--device",
         "cpu"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(base, RANK=str(r), LOCAL_RANK=str(r % LOCAL)))
        for r in range(world)]
    docs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            lines = [l for l in out.splitlines() if l.startswith("MHRESULT ")]
            assert lines, f"no MHRESULT line in: {out}"
            docs.append(json.loads(lines[0][len("MHRESULT "):]))
    finally:
        # a failed or stuck rank must not leave its peers blocked
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return docs


def test_hybrid_mesh_is_two_hosts_of_two_local_ranks(hosts):
    assert [d["rank"] for d in hosts] == [0, 1, 2, 3]
    for d in hosts:
        assert (d["world"], d["backend"]) == (4, "gloo")
        assert d["shape"] == {"dcn": HOSTS, "data": LOCAL}
    # a host's ranks are consecutive (a row); dcn joins the hosts' places
    assert [tuple(d["data_ranks"]) for d in hosts] == [(0, 1), (0, 1),
                                                       (2, 3), (2, 3)]
    assert [tuple(d["dcn_ranks"]) for d in hosts] == [(0, 2), (1, 3),
                                                      (0, 2), (1, 3)]


def test_psum_over_both_axes_sums_every_rank(hosts):
    for d in hosts:
        assert d["psum"] == d["expected_psum"] == float(sum(range(4)))


def test_hll_merge_equals_the_single_device_plane_of_the_union(hosts):
    union = hll_add(hll_init(10, device="cpu"),
                    torch.arange(0, 4 * 500, dtype=torch.int32), p=10)
    for d in hosts:
        assert d["hll"] == union.tolist()
        assert d["hll_estimate"] == pytest.approx(d["true_distinct"],
                                                  rel=0.05)


def test_process_local_gcn_step_leaves_replicas_equal(hosts):
    loss = hosts[0]["train_loss"]
    assert loss > 0 and all(d["train_loss"] == loss for d in hosts)
    assert len({d["params_digest"] for d in hosts}) == 1


def _single_process():
    mesh = make_hybrid_mesh(device="cpu")
    x = process_local_array(mesh, [3.0])
    return (mesh.shape, dcn_data_parallel_spec(mesh),
            replicated_value(x).tolist())


def test_single_process_mesh_is_1_by_1(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    # no launcher environment: nothing to join
    assert initialize_distributed(device="cpu") is False
    shape, spec, value = launch(_single_process, 1, device="cpu")[0]
    assert shape == {"dcn": 1, "data": 1}
    assert spec == ("dcn", "data") and value == [3.0]


def _uneven():
    with pytest.raises(ValueError, match="do not split into hosts"):
        make_hybrid_mesh(device="cpu")


def test_incomplete_environment_and_uneven_hosts_refused(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="LOCAL_RANK, LOCAL_WORLD_SIZE, "
                       "MASTER_ADDR, MASTER_PORT unset"):
        initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")     # 1 rank, hosts of 2
    launch(_uneven, 1, device="cpu")
