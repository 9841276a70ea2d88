"""The port's device meshes and multi-process bring-up against the JAX
package's (``parallel/mesh.py``).

- ``make_mesh`` and ``data_model_mesh`` give JAX's axis sizes and its
  error text on the same device counts (the tests' CPU devices; JAX's are
  conftest's eight fake CPU devices). Where JAX's ``data_model_mesh`` is
  asked for more data rows than it has devices it returns an empty mesh;
  the port raises make_mesh's text there (ROADMAP queue 3).
- Without a card the meshes raise instead of taking the CPU.
- Two processes form a gloo group through
  ``initialize_distributed(device="cpu")`` and all-gather ``[pid + 1]`` to
  ``[1, 2]``, as tests/test_distributed_init.py does with JAX's.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from visual_odom_tpu.parallel import mesh as jmesh
from visual_odom_tpu_torch.parallel import mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.mark.parametrize("axes", [{"data": 2, "model": 1},
                                  {"data": 2, "model": 4}, {"seq": 8},
                                  {"data": 1, "model": 3}])
def test_make_mesh_axis_sizes_equal_jax(axes):
    devices = [CPU] * 8
    got = mesh.make_mesh(axes, devices)
    ref = jmesh.make_mesh(axes, jax.devices()[:8])
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)
    assert got.devices.shape == ref.devices.shape
    assert all(d == CPU for d in got.devices.flat)


@pytest.mark.parametrize("have, axes", [(1, {"data": 2, "model": 1}),
                                        (3, {"data": 2, "model": 2}),
                                        (4, {"seq": 8})])
def test_make_mesh_error_text_equals_jax(have, axes):
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(axes, jax.devices()[:have])
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(axes, [CPU] * have)
    assert str(got.value) == str(ref.value)
    assert "mesh wants" in str(got.value)


@pytest.mark.parametrize("n, data", [(8, None), (6, None), (3, None),
                                     (1, None), (8, 4), (8, 1), (4, 2)])
def test_data_model_mesh_equals_jax(monkeypatch, n, data):
    """JAX's arithmetic: data = 2 on an even count, else 1; the rest goes
    to "model"."""
    monkeypatch.setattr(jax, "devices", lambda: jax.local_devices()[:n])
    ref = jmesh.data_model_mesh(data=data)
    got = mesh.data_model_mesh(data=data, devices=[CPU] * n)
    assert got.shape == dict(ref.shape) and got.size == ref.devices.size


def test_data_model_mesh_more_data_than_devices(monkeypatch):
    """JAX returns an empty (2, 0) mesh; the port refuses with make_mesh's
    text, which the CLI's ``run-batch --data-parallel 2`` prints."""
    monkeypatch.setattr(jax, "devices", lambda: jax.local_devices()[:1])
    assert jmesh.data_model_mesh(data=2).devices.size == 0
    with pytest.raises(ValueError, match="mesh wants 2 devices, only 1 "
                                         "available"):
        mesh.data_model_mesh(data=2, devices=[CPU])


@pytest.mark.parametrize("entry", ["make_mesh", "data_model_mesh",
                                   "initialize_distributed"])
def test_default_devices_need_a_card(monkeypatch, entry):
    """Without ``devices`` (or ``device``) the meshes take the visible CUDA
    devices: without a card they raise, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"make_mesh": lambda: mesh.make_mesh({"data": 1}),
             "data_model_mesh": lambda: mesh.data_model_mesh(),
             "initialize_distributed": lambda: mesh.initialize_distributed(
                 "127.0.0.1:1", 1, 0)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


_WORKER = textwrap.dedent("""
    import sys

    import torch
    import torch.distributed as dist

    from visual_odom_tpu_torch.parallel.mesh import initialize_distributed

    coordinator, pid = sys.argv[1], int(sys.argv[2])
    initialize_distributed(coordinator=coordinator, num_processes=2,
                           process_id=pid, device="cpu")
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    assert dist.get_backend() == "gloo"
    out = [torch.zeros(1, dtype=torch.int32) for _ in range(2)]
    dist.all_gather(out, torch.tensor([pid + 1], dtype=torch.int32))
    gathered = sorted(int(x) for x in out)
    assert gathered == [1, 2], gathered
    dist.destroy_process_group()
    print(f"proc {pid} OK", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_distributed_two_processes(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(worker), coordinator,
                               str(i)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
