"""The port's runtime across ranks (core/mesh.py, core/cluster.py) against
the JAX package's, on the CPU.

Mirrors ``tests/test_mesh.py`` and the stdlib half of
``tests/test_cluster.py``: the mesh's axis sizes and ``MeshSizeError`` from
the same ``MeshConfig`` at the same device count as the JAX
``_resolve_axis_sizes``; the refusals of every axis other than ``data``
and ``fsdp`` (tests/test_torch_fsdp.py holds the subgroups);
the gang environment (the discovery triple of ``worker_env``, the
heartbeat names, the exit barrier); a run without the environment is one
rank with no process group; and ``cli.train`` exits with rc 84 when the
mesh asks for more ranks than the gang has. Everything here is exact.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from distributed_tensorflow_framework_torch.cli import train as port_cli
from distributed_tensorflow_framework_torch.core import cluster, mesh
from distributed_tensorflow_framework_torch.core import supervision
from distributed_tensorflow_framework_torch.core.config import MeshConfig
from distributed_tensorflow_framework_tpu.core import cluster as jax_cluster
from distributed_tensorflow_framework_tpu.core import (
    supervision as jax_supervision,
)
from distributed_tensorflow_framework_tpu.core.config import (
    MeshConfig as JaxMeshConfig,
)
from distributed_tensorflow_framework_tpu.core.mesh import (
    MESH_AXES as JAX_MESH_AXES,
)
from distributed_tensorflow_framework_tpu.core.mesh import (
    MeshSizeError as JaxMeshSizeError,
)
from distributed_tensorflow_framework_tpu.core.mesh import (
    _resolve_axis_sizes as jax_resolve,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

GANG_VARS = (cluster.ENV_COORDINATOR, cluster.ENV_NUM_PROCESSES,
             cluster.ENV_PROCESS_ID)


@pytest.fixture()
def no_gang(monkeypatch):
    for var in GANG_VARS:
        monkeypatch.delenv(var, raising=False)


def _outcome(resolve, config, n):
    try:
        return resolve(config, n)
    except (JaxMeshSizeError, mesh.MeshSizeError) as e:
        return ("MeshSizeError", e.sizes, e.needed, e.available)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("sizes, n", [
    ({}, 1), ({}, 8), ({"data": 2}, 2), ({"data": 2}, 1), ({"data": 2}, 4),
    ({"data": -1, "model": 2}, 8), ({"data": -1, "model": 2}, 3),
    ({"data": 3, "model": 2}, 8), ({"data": -1, "fsdp": -1}, 4),
    ({"data": 1}, 1), ({"data": -1, "seq": 4, "pipe": 2}, 16),
])
def test_axis_sizes_match_jax(sizes, n):
    ours = _outcome(mesh._resolve_axis_sizes, MeshConfig(**sizes), n)
    ref = _outcome(jax_resolve, JaxMeshConfig(**sizes), n)
    assert ours == ref
    assert mesh.MESH_AXES == JAX_MESH_AXES


@pytest.mark.parametrize("axis, item", [
    ("fsdp", "A10"), ("model", "A10"), ("seq", "A11"), ("pipe", "A12"),
    ("expert", "A8")])
def test_non_data_axes_name_their_item(axis, item):
    """Every axis is ported now (fsdp and model by A10's FSDP and
    tensor-parallel halves, seq by A11, pipe by A12, expert by A8): each
    resolves above 1 (fixed or free) as the JAX mesh does."""
    if axis in ("fsdp", "model", "seq", "pipe", "expert"):
        assert mesh.resolve_mesh(MeshConfig(data=1, **{axis: 2}), 2)[
            axis] == 2
        assert mesh.resolve_mesh(MeshConfig(data=2, **{axis: 2}), 4) == \
            jax_resolve(JaxMeshConfig(data=2, **{axis: 2}), 4)
        assert mesh.resolve_mesh(MeshConfig(data=1, **{axis: -1}), 2)[
            axis] == 2
        assert mesh.resolve_mesh(MeshConfig(data=1, **{axis: -1}), 1)[
            axis] == 1
        return
    with pytest.raises(NotImplementedError, match=item):
        mesh.resolve_mesh(MeshConfig(**{axis: 2}), 2)
    # A free non-data axis resolves above 1 across ranks and is refused
    # too; on one rank it is 1.
    with pytest.raises(NotImplementedError, match=item):
        mesh.resolve_mesh(MeshConfig(data=1, **{axis: -1}), 2)
    assert mesh.resolve_mesh(MeshConfig(data=1, **{axis: -1}), 1)[axis] == 1


@pytest.mark.parametrize("env, want", [
    ({}, None),
    ({cluster.ENV_COORDINATOR: "h:1"}, None),
    ({cluster.ENV_NUM_PROCESSES: "2"}, None),
    ({cluster.ENV_COORDINATOR: "h:1", cluster.ENV_NUM_PROCESSES: "2"},
     ("h:1", 2, 0)),
    ({cluster.ENV_COORDINATOR: "10.0.0.1:77", cluster.ENV_NUM_PROCESSES: "4",
      cluster.ENV_PROCESS_ID: "3"}, ("10.0.0.1:77", 4, 3)),
    ({cluster.ENV_COORDINATOR: "h:1", cluster.ENV_NUM_PROCESSES: "1",
      cluster.ENV_PROCESS_ID: "0"}, ("h:1", 1, 0)),
])
def test_gang_environment_parsing(env, want):
    assert mesh.gang_from_env(env) == want


@pytest.mark.parametrize("count, pid", [("two", "0"), ("2", "x"),
                                        ("2", "2"), ("0", "0")])
def test_bad_gang_environment_is_a_typed_error(count, pid):
    env = {cluster.ENV_COORDINATOR: "h:1", cluster.ENV_NUM_PROCESSES: count,
           cluster.ENV_PROCESS_ID: pid}
    with pytest.raises(cluster.ClusterSpecError):
        mesh.gang_from_env(env)


def test_no_environment_is_one_rank_without_a_group(no_gang):
    rt = mesh.initialize_runtime(MeshConfig(), "cpu")
    assert (rt.process_index, rt.process_count, rt.backend) == (0, 1, None)
    assert rt.is_chief and rt.data_parallel_size == 1
    assert not dist.is_initialized()
    assert rt.sizes == {"data": 1, "fsdp": 1, "expert": 1, "pipe": 1,
                        "model": 1, "seq": 1}
    assert rt.broadcast_int(5) == 5 and rt.broadcast_int(None) is None
    rt.shutdown()


def test_mesh_data_2_in_one_process_exits_84(no_gang, caplog):
    rc = port_cli.main(["--device", "cpu", "--set", "mesh.data=2",
                        "--set", "checkpoint.directory="])
    assert rc == supervision.ELASTIC_RESHARD_RC == \
        jax_supervision.ELASTIC_RESHARD_RC == 84
    assert "needs 2 devices but 1 are available" in caplog.text


def test_a_non_data_axis_raises_in_the_cli(no_gang, caplog):
    """``expert`` is a valid axis: a mesh of two expert ranks in one
    process does not fit, which is the elastic rc 84."""
    rc = port_cli.main(["--device", "cpu", "--set", "mesh.data=1",
                        "--set", "mesh.expert=2",
                        "--set", "checkpoint.directory="])
    assert rc == supervision.ELASTIC_RESHARD_RC == 84
    assert "needs 2 devices but 1 are available" in caplog.text


@pytest.mark.parametrize("index, count", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_heartbeat_names_match_jax(index, count, tmp_path):
    assert cluster.heartbeat_name(index, count) == \
        jax_cluster.heartbeat_name(index, count)
    assert cluster.heartbeat_path(str(tmp_path), index, count) == \
        jax_cluster.heartbeat_path(str(tmp_path), index, count)


def test_heartbeat_out_of_range_is_a_typed_error():
    with pytest.raises(cluster.ClusterSpecError):
        cluster.heartbeat_name(2, 2)


@pytest.mark.parametrize("count, pid", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_worker_env_sets_the_jax_discovery_triple(count, pid):
    base = {"KEEP": "1", cluster.ENV_PROCESS_ID: "9"}
    ours = cluster.worker_env(base, coordinator_port=1234,
                              num_processes=count, process_id=pid)
    ref = jax_cluster.worker_env(base, coordinator_port=1234,
                                 num_processes=count, process_id=pid,
                                 devices_per_proc=1)
    for key in (*GANG_VARS, "KEEP"):
        assert ours.get(key) == ref.get(key)
    assert base == {"KEEP": "1", cluster.ENV_PROCESS_ID: "9"}
    if count > 1:
        assert mesh.gang_from_env(ours) == ("127.0.0.1:1234", count, pid)
    else:
        assert mesh.gang_from_env(ours) is None
    with pytest.raises(cluster.ClusterSpecError):
        cluster.worker_env(base, coordinator_port=1, num_processes=count,
                           process_id=count)


def test_exit_barrier_waits_for_the_commit_record():
    seen = iter([None, 3, 4])
    slept = []
    assert cluster.exit_barrier("d", step=4, timeout_s=10.0, poll_s=0.25,
                                latest_step_fn=lambda d: next(seen),
                                sleep=slept.append, clock=lambda: 0.0) == 4
    assert slept == [0.25, 0.25]
    clock = iter([0.0, 0.0, 11.0])
    with pytest.raises(cluster.ExitBarrierTimeoutError, match="step 4"):
        cluster.exit_barrier("d", step=4, timeout_s=10.0,
                             latest_step_fn=lambda d: 3, sleep=slept.append,
                             clock=lambda: next(clock))


def test_latest_committed_step_reads_the_manifests(tmp_path):
    from distributed_tensorflow_framework_torch.ckpt import manifest

    assert cluster.latest_committed_step(str(tmp_path)) is None
    for step in (2, 5):
        step_dir = tmp_path / str(step)
        step_dir.mkdir()
        (step_dir / "state.pt").write_bytes(b"x" * step)
        manifest.write_manifest(str(step_dir), step)
    (tmp_path / "7").mkdir()  # uncommitted
    assert cluster.latest_committed_step(str(tmp_path)) == 5 == \
        jax_cluster.latest_committed_step(str(tmp_path))


def test_runtime_is_a_plain_record():
    cpu = torch.device("cpu")
    rt = mesh.MeshRuntime({"data": 4, "fsdp": 1, "expert": 1, "pipe": 1,
                           "model": 1, "seq": 1}, 2, 4, cpu, "gloo")
    assert not rt.is_chief and rt.data_parallel_size == 4
    assert rt.collective_device == cpu
    assert "rank 2/4" in rt.describe()
    assert dataclasses.replace(rt, process_index=0).is_chief


def test_seq_coordinates_and_the_ring_transport():
    """Rank order with ``seq`` (inside data × fsdp, outside model), the
    global rank of each member of a seq line, and how ``ppermute_`` moves
    tensors: natively on NCCL and on gloo's CPU tensors, through the host
    for gloo's CUDA tensors; without a group it copies."""
    sizes = {"data": 2, "fsdp": 1, "expert": 1, "pipe": 1, "model": 2,
             "seq": 2}
    for rank in range(8):
        coords = mesh._coords(sizes, rank)
        assert rank == ((coords["data"] * 2 + coords["seq"]) * 2
                        + coords["model"])
    rt = mesh.MeshRuntime(sizes, 5, 8, torch.device("cpu"), "gloo")
    assert [rt.member_rank("seq", j) for j in range(2)] == [5, 7]
    assert rt.p2p_transport("cpu") == mesh.TRANSPORT_NATIVE
    assert rt.p2p_transport("cuda") == mesh.TRANSPORT_HOST
    nccl = dataclasses.replace(rt, backend="nccl")
    assert nccl.p2p_transport("cuda") == mesh.TRANSPORT_NATIVE
    one = mesh.MeshRuntime({**sizes, "data": 1, "model": 1, "seq": 1}, 0,
                           1, torch.device("cpu"))
    x = torch.arange(4.0)
    out = torch.empty(4)
    assert one.ppermute_([out], [x])[0] is out and torch.equal(out, x)


def test_pipe_coordinates_and_the_line_groups():
    """Rank order with ``pipe`` (inside data × fsdp, outside seq and
    model), the global rank of each stage of a pipe line, this rank's
    stage, and ``ppermute_`` along ``pipe`` without a group (a copy)."""
    sizes = {"data": 2, "fsdp": 1, "expert": 1, "pipe": 4, "seq": 1,
             "model": 1}
    for rank in range(8):
        coords = mesh._coords(sizes, rank)
        assert rank == coords["data"] * 4 + coords["pipe"]
    rt = mesh.MeshRuntime(sizes, 6, 8, torch.device("cpu"), "gloo")
    assert [rt.member_rank("pipe", j) for j in range(4)] == [4, 5, 6, 7]
    assert rt.data_parallel_size == 2
    # A pipe line over every rank: the default group's coordinates, and no
    # line group formed here.
    line = mesh.MeshRuntime({**sizes, "data": 1}, 2, 4,
                            torch.device("cpu"), "gloo")
    assert (line.pipe_group.index, line.pipe_group.size) == (2, 4)
    assert line.pipe_group.group is None and line.seq_group.group is None
    assert (line.data_group.index, line.data_group.size) == (0, 1)
    assert mesh.LINE_AXES == (("expert",), ("pipe",), ("seq",),
                              ("data", "fsdp", "expert"))
    assert line.expert_group.group is None
    assert line.router_group.group is None
    one = mesh.MeshRuntime({**sizes, "data": 1, "pipe": 1}, 0, 1,
                           torch.device("cpu"))
    x = torch.arange(4.0)
    out = torch.empty(4)
    assert one.ppermute_([out], [x], 1, "pipe")[0] is out
    assert torch.equal(out, x)
    assert torch.equal(one.line_broadcast_(x.clone(), "pipe", 0), x)
