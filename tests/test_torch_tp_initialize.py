"""The port's bounded process-group start (``parallel.distributed.
initialize``) and the mesh's preconditions, in one process:

- no address and no ``RANK``/``WORLD_SIZE``: a single process, nothing to
  join (False at once);
- a world of 2 in which one rank joins raises RuntimeError within the
  given timeout, naming the address, the world size and the timeout
  (fail-stop, never a hang), at a ``file://`` and at a ``host:port``
  address (read as ``tcp://``);
- a mesh of more than one rank needs the group, and its size must be
  dp * tp; a 1 x 1 mesh needs none.
"""

import socket
import time

import pytest
import torch.distributed as dist

from zig_gpt2_tpu_torch.parallel import distributed as pdist
from zig_gpt2_tpu_torch.parallel.mesh import make_mesh

TIMEOUT_S = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_single_process_returns_at_once(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pdist.initialize() is False
    assert pdist.initialize(num_processes=1) is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("address", ["file", "host:port"])
def test_missing_rank_raises_within_the_timeout(tmp_path, address):
    addr = (f"file://{tmp_path}/rendezvous" if address == "file"
            else f"localhost:{_free_port()}")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as err:
        pdist.initialize(addr, num_processes=2, process_id=0, init_timeout_s=TIMEOUT_S)
    elapsed = time.perf_counter() - t0
    assert elapsed < 10 * TIMEOUT_S, elapsed
    msg = str(err.value)
    want = addr if address == "file" else f"tcp://{addr}"
    assert repr(want) in msg and "world_size=2" in msg and f"timeout={TIMEOUT_S}s" in msg
    assert not dist.is_initialized()


def test_mesh_needs_the_group(monkeypatch):
    assert make_mesh(1, 1).model.size == 1
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="positive"):
        make_mesh(0, 2)


@pytest.mark.parametrize("flags,match", [
    (["--draft-model", "demo"], "single-device"),
    (["--prefix", "the"], "slice 12"),
    (["--seq-parallel"], "slice 12"),
    (["--mesh", "2"], "expected DPxTP"),
], ids=["draft-model", "prefix", "seq-parallel", "malformed"])
def test_cli_mesh_refusals(flags, match):
    """What the mesh does not serve yet is refused before any rank starts:
    speculation (as the JAX CLI refuses it), prefix caching and
    sequence-parallel prefill (slice 12), and a malformed shape."""
    from zig_gpt2_tpu_torch import cli

    argv = ["--demo", "--device", "cpu", "--mesh", "1x2", *flags, "hi"]
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)
