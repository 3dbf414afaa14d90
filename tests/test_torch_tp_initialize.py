"""The port's bounded process-group start (``parallel.distributed.
initialize``) and the mesh's preconditions, in one process:

- no address and no ``RANK``/``WORLD_SIZE``: a single process, nothing to
  join (False at once);
- a world of 2 in which one rank joins raises RuntimeError within the
  given timeout, naming the address, the world size and the timeout
  (fail-stop, never a hang), at a ``file://`` and at a ``host:port``
  address (read as ``tcp://``);
- a mesh of more than one rank needs the group, and its size must be
  dp * tp; a 1 x 1 mesh needs none;
- a group on the card whose backend takes no reduce-scatter, even
  through the host, is refused when it is made;
- the mesh's device follows the engine's rule (the card unless the caller
  asks for the CPU; RuntimeError without a card), and the engine and the
  batcher refuse a mesh on a device other than theirs;
- the CLI refuses under ``--mesh`` only what the JAX CLI refuses there,
  before any rank starts.
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
    assert make_mesh(1, 1, device="cpu").model.size == 1
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        make_mesh(0, 2, device="cpu")


def test_group_without_reduce_scatter_is_refused(monkeypatch):
    """The probes stand in for a backend that takes every operation but
    reduce-scatter, on the card's tensors and on the host's."""
    import torch

    probed = []

    def probe(self, op, dev):
        probed.append((op, torch.device(dev).type))
        return op != "reduce_scatter"

    monkeypatch.setattr(pdist.Collectives, "_probe", probe)
    with pytest.raises(RuntimeError, match="no reduce-scatter"):
        pdist.Collectives([0, 1], 0, "cuda")
    assert probed[-2:] == [("reduce_scatter", "cuda"), ("reduce_scatter", "cpu")]


def test_mesh_device_follows_the_engine_rule(monkeypatch):
    """``make_mesh`` defaults to the card: without one it raises, as the
    engine does, and asks for the CPU explicitly; a runtime whose device
    is not the mesh's refuses it."""
    import torch

    from zig_gpt2_tpu_torch.config import GPT2_NANO
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
    from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1, 1)
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.device == torch.device("cpu")
    params = gpt2.init_params(GPT2_NANO, torch.Generator().manual_seed(0))
    InferenceEngine(GPT2_NANO, params, device="cpu", mesh=mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="the mesh lives on cpu"):
        InferenceEngine(GPT2_NANO, params, device="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="the mesh lives on cpu"):
        ContinuousBatcher(GPT2_NANO, params, batch_size=2, device="cuda", mesh=mesh)


@pytest.mark.parametrize("flags,match", [
    (["--draft-model", "demo"], "single-device"),
    (["--prefix", "the"], None),
    (["--seq-parallel"], None),
    (["--mesh", "2"], "expected DPxTP"),
], ids=["draft-model", "prefix", "seq-parallel", "malformed"])
def test_cli_mesh_refusals(flags, match, monkeypatch):
    """Under ``--mesh`` the CLI refuses before any rank starts only what
    the JAX CLI refuses there: a draft model (single-prompt speculation is
    single-device) and a malformed shape. Prefix caching and
    sequence-parallel prefill go on to the ranks (the spawn is stubbed
    here; ``tests/test_torch_tp_cli.py`` serves them)."""
    import torch.multiprocessing as mp

    from zig_gpt2_tpu_torch import cli

    started = []
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs: started.append((args[0], nprocs)))
    argv = ["--demo", "--device", "cpu", "--mesh", "1x2", *flags, "hi"]
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            cli.main(argv)
        assert not started
        return
    cli.main(argv)
    (args, nprocs), = started
    assert nprocs == 2 and (args.prefix == "the" or args.seq_parallel)
